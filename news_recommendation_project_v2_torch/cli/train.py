"""Training CLI: transform -> the per-split embedding dumps (or an inline
encode) -> the content scorer -> the user tower, with the final scores
logged. Checkpoints (``Best_model_<exp>``, ``Epoch_N``) are the port's
``torch.save`` state dicts, which ``nrtorch-eval --ckpt`` and
``nrtorch-serve --ckpt`` load.

    nrtorch-train DATA_DIR --train MINDsmall_train --dev MINDsmall_dev \
        --emb-dir embeddings --tower latent --epochs 5

``--mesh DATA,MODEL`` trains the content scorer and the tower data parallel
over DATA x MODEL ranks, one process each, started by torchrun:

    torchrun --nproc-per-node 2 -m news_recommendation_project_v2_torch.cli.train \
        DATA_DIR --emb-dir embeddings --mesh 2,1

NCCL joins the ranks on CUDA (one card each), gloo on the CPU
(``--device cpu``); ``--dist-backend gloo`` lets ranks share a card. Only
rank 0 prints the metrics and writes the logs and checkpoints.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch.distributed as dist

from ..config import MeshConfig, NewsDataset, TowerConfig, TrainConfig, tower_kwargs_for_dim
from ..pipeline import (
    AttentionComponent,
    ClassificationComponent,
    LoadEmbeddingComponent,
    Pipeline,
    TransformDataComponent,
)
from .common import add_device_argument, build_context, log_final_scores


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("--train", default="MINDsmall_train", choices=NewsDataset._member_names_)
    parser.add_argument("--dev", default="MINDsmall_dev", choices=NewsDataset._member_names_)
    parser.add_argument("--emb-dir", type=Path, default=Path("embeddings"))
    parser.add_argument(
        "--encode-inline",
        action="store_true",
        help="encode the news texts inside the pipeline instead of loading a dump",
    )
    parser.add_argument("--hf-checkpoint", type=Path, default=None)
    parser.add_argument("--max-length", type=int, default=128)
    parser.add_argument("--tower", default="latent", choices=["latent", "final_attention", "transformer"])
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--cls-epochs", type=int, default=1)
    parser.add_argument("--batch-size", type=int, default=512)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--dim", type=int, default=None, help="embedding dim override")
    parser.add_argument(
        "--mesh",
        default=None,
        metavar="DATA,MODEL",
        help="data-parallel training over DATA x MODEL ranks (run under torchrun)",
    )
    parser.add_argument(
        "--dist-backend",
        choices=["nccl", "gloo"],
        default=None,
        help="the mesh's backend (default: nccl on CUDA, gloo on the CPU; gloo lets ranks share a card)",
    )
    parser.add_argument("--log-dir", type=Path, default=Path("logs"))
    parser.add_argument("--ckpt-dir", type=Path, default=Path("models"))
    parser.add_argument("--exp-name", default=None)
    parser.add_argument("--no-cache", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    mesh = None
    if args.mesh:
        from ..parallel import build_mesh

        try:
            data_size, model_size = (int(x) for x in args.mesh.split(","))
        except ValueError:
            parser.error("--mesh wants DATA,MODEL integers, e.g. 2,1")
        if data_size < 1 or model_size < 1:
            parser.error("--mesh wants positive sizes")
        mesh = build_mesh(
            MeshConfig(data_size=data_size, model_size=model_size), backend=args.dist_backend, device=args.device
        )
    rank0 = mesh is None or mesh.rank == 0

    train_ds = NewsDataset[args.train]
    dev_ds = NewsDataset[args.dev]
    exp_name = args.exp_name or f"e5_query_{args.tower}"
    tower_cfg = TowerConfig(kind=args.tower, **tower_kwargs_for_dim(args.dim))
    cls_cfg = TrainConfig(learning_rate=args.lr, num_epochs=args.cls_epochs, batch_size=args.batch_size)
    attn_cfg = TrainConfig(learning_rate=args.lr, num_epochs=args.epochs, batch_size=args.batch_size)

    if args.encode_inline:
        from ..config import QUERY_INSTRUCTION
        from ..pipeline import EmbeddingsComponent
        from .common import build_encoder, tiny_encoder_config

        if args.hf_checkpoint and args.dim:
            parser.error(
                "--hf-checkpoint uses the full-size encoder; drop --dim "
                "(tower dims then default to the checkpoint's 1024)"
            )
        enc_cfg = tiny_encoder_config(args.max_length, args.dim) if args.dim else None
        enc, tok = build_encoder(args.hf_checkpoint, enc_cfg, args.max_length, device=args.device)
        embedding_step = ("embed", EmbeddingsComponent(enc, tok, QUERY_INSTRUCTION, device=args.device))
    else:
        embedding_step = ("load_embedding", _PerSplitLoad(args.emb_dir))

    pipe = Pipeline(
        name=f"train_{exp_name}",
        steps=[
            ("init_transform", TransformDataComponent()),
            embedding_step,
            (
                "classification",
                ClassificationComponent(
                    cfg=cls_cfg,
                    log_dir=args.log_dir,
                    ckpt_dir=args.ckpt_dir / "classification",
                    exp_name=exp_name,
                    mesh=mesh,
                    device=args.device,
                ),
            ),
            (
                "only_attention",
                AttentionComponent(
                    tower_config=tower_cfg,
                    cfg=attn_cfg,
                    log_dir=args.log_dir,
                    ckpt_dir=args.ckpt_dir / "attention",
                    exp_name=exp_name,
                    mesh=mesh,
                    device=args.device,
                ),
            ),
        ],
        use_cache=not args.no_cache,
    )
    train_context = build_context(args.data_dir, train_ds)
    val_context = build_context(args.data_dir, dev_ds)
    train_context, val_context = pipe.train(train_context, val_context)

    if rank0:
        log_final_scores(args.log_dir, exp_name, train_context.get("metrics"), val_context.get("metrics"))
        print("train metrics:", train_context.get("metrics"))
        print("dev metrics:", val_context.get("metrics"))
    return pipe, train_context, val_context


class _PerSplitLoad(LoadEmbeddingComponent):
    """Loads the dump of each context's own split."""

    def __init__(self, save_dir: Path):
        super().__init__(save_dir, dataset_name="", with_query=True)

    def transform(self, context):
        self.dataset_name = context["dataset_name"]
        return super().transform(context)


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
