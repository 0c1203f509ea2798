"""The baseline reproduction in one command: ingest -> tokenize and encode
(a real checkpoint where given) -> the presets config[0], config[1] and,
with ``--with-e2e``, config[2] -> one metric row per config.

Real MIND data:

    nrtorch-reproduce DATA_DIR --hf-checkpoint /path/to/e5-large-instruct

Offline, on the synthetic fixture:

    nrtorch-reproduce DATA_DIR --synthetic --tiny-encoder --epochs 1 --device cpu

DATA_DIR holds the raw MIND TSVs under ``raw/<dataset>/`` (``--synthetic``
writes them). Rows print as ``CONFIG_ROW {json}`` lines and go to ``--out``
as JSON. The mesh presets, config[3] and config[4], run with two or more
GPUs, one NCCL rank each (``parallel.launch``); with fewer they are
skipped, as the JAX package skips them. On the CPU, ``--cpu-ranks N`` runs
them on N gloo ranks (the JAX package's virtual CPU mesh):

    nrtorch-reproduce DATA_DIR --synthetic --tiny-encoder --epochs 1 --device cpu --cpu-ranks 2
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..config import QUERY_INSTRUCTION, NewsDataset, TrainConfig
from ..device import resolve_device
from .common import add_device_argument, build_context, build_encoder, tiny_encoder_config


def _compile_and_encode(data_dir, dataset, enc, tok, device):
    from ..pipeline import EmbeddingsComponent, Pipeline, TransformDataComponent

    pipe = Pipeline(
        name=f"reproduce_{dataset.value}",
        steps=[
            ("transform", TransformDataComponent()),
            ("embed", EmbeddingsComponent(enc, tok, QUERY_INSTRUCTION, batch_size=None, device=device)),
        ],
        use_cache=False,
    )
    ctx, _ = pipe.transform(build_context(data_dir, dataset))
    return ctx


def _mesh_configs(c_train, emb_train, c_dev, emb_dev, mesh_cfg, train_cfg, tower_cfg, ids, mask, encoder, device):
    """One rank of configs 3-4: ``run_config3``, then ``run_config4`` over
    the dev corpus's tokens."""
    from ..configs import run_config3, run_config4

    m3 = run_config3(
        c_train, emb_train, c_dev, emb_dev, mesh_cfg=mesh_cfg, train_cfg=train_cfg, tower_cfg=tower_cfg, device=device,
    )
    return m3, run_config4(c_dev, ids, mask, encoder, mesh_cfg=mesh_cfg, device=device)


def _row(index: int, description: str, metrics: dict) -> dict:
    return {
        "config": index,
        "description": description,
        **{k: round(float(v), 4) for k, v in metrics.items()},
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("--train-dataset", default="MINDsmall_train", choices=NewsDataset._member_names_)
    parser.add_argument("--dev-dataset", default="MINDsmall_dev", choices=NewsDataset._member_names_)
    parser.add_argument("--hf-checkpoint", type=Path, default=None,
                        help="HF e5 checkpoint dir (real tokenizer + weights)")
    parser.add_argument("--synthetic", action="store_true",
                        help="generate the synthetic raw fixture first")
    parser.add_argument("--tiny-encoder", action="store_true",
                        help="small random encoder (offline dry run)")
    parser.add_argument("--max-length", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--lr", type=float, default=1e-5)
    parser.add_argument("--with-e2e", action="store_true",
                        help="also run config[2] (frozen token store + end to end)")
    parser.add_argument("--out", type=Path, default=Path("reproduction.json"))
    parser.add_argument("--cpu-ranks", type=int, default=0,
                        help="with --device cpu, run configs 3-4 on this many gloo ranks of the CPU "
                             "(the counterpart of the JAX package's virtual CPU mesh, "
                             "XLA_FLAGS=--xla_force_host_platform_device_count=N); on CUDA they run "
                             "with one NCCL rank per GPU")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    from ..config import MeshConfig
    from ..configs import BASELINE_CONFIGS, _sized_tower, run_config0, run_config1, run_config2
    from ..data.ingest import store_processed_data

    if args.cpu_ranks and torch.device(args.device or "cuda").type != "cpu":
        parser.error("--cpu-ranks runs configs 3-4 on the CPU: pass --device cpu (on CUDA one rank runs per GPU)")
    device = resolve_device(args.device)
    ranks, backend = (torch.cuda.device_count(), "nccl") if device.type == "cuda" else (args.cpu_ranks, "gloo")
    train_ds = NewsDataset[args.train_dataset]
    dev_ds = NewsDataset[args.dev_dataset]

    # 1. Ingest (nrtorch-ingest).
    if args.synthetic:
        from ..data.synthetic import write_synthetic_mind

        for ds in (train_ds, dev_ds):
            write_synthetic_mind(args.data_dir, ds)
    for ds in (train_ds, dev_ds):
        store_processed_data(args.data_dir, ds)

    # 2. The encoder and tokenizer (nrtorch-save-emb, kept in memory).
    enc_cfg = tiny_encoder_config(args.max_length) if args.tiny_encoder else None
    enc, tok = build_encoder(args.hf_checkpoint, enc_cfg, args.max_length, device=device)
    ctx_train = _compile_and_encode(args.data_dir, train_ds, enc, tok, device)
    ctx_dev = _compile_and_encode(args.data_dir, dev_ds, enc, tok, device)
    c_train, c_dev = ctx_train["compiled"], ctx_dev["compiled"]
    emb_train = ctx_train["news_embeddings"]
    emb_dev = ctx_dev["news_embeddings"]
    query_dev = ctx_dev["query_news_embeddings"]
    dim = emb_train.shape[1]
    train_cfg = TrainConfig(learning_rate=args.lr, num_epochs=args.epochs, batch_size=args.batch_size)

    rows = []

    def emit(index, metrics):
        row = _row(index, BASELINE_CONFIGS[index].description, metrics)
        rows.append(row)
        print("CONFIG_ROW", json.dumps(row), flush=True)

    # 3. The scenarios.
    emit(0, run_config0(c_dev, emb_dev, query_news_embeddings=query_dev, device=device))
    emit(1, run_config1(
        c_train, emb_train, c_dev, emb_dev, train_cfg=train_cfg, tower_cfg=_sized_tower(dim), device=device,
    ))
    if args.with_e2e:
        from ..ops.encode import build_token_store

        store = build_token_store(
            enc, *tok([ctx_train["news_text_dict"][n] for n in c_train.news_ids]), batch_size=16, device=device
        )
        emit(2, run_config2(
            c_train, store, dim=dim,
            train_cfg=TrainConfig(
                learning_rate=args.lr, num_epochs=max(1, args.epochs // 5), batch_size=min(32, args.batch_size),
            ),
            max_token_len=args.max_length,
            device=device,
        ))
    if ranks >= 2:
        from ..parallel import launch

        mesh_cfg = MeshConfig(model_size=2 if ranks % 2 == 0 else 1)
        ids, mask = tok([ctx_dev["news_text_dict"][n] for n in c_dev.news_ids], max_length=args.max_length)
        results = launch(
            _mesh_configs, ranks,
            args=(c_train, emb_train, c_dev, emb_dev, mesh_cfg, train_cfg, _sized_tower(dim), ids, mask, enc.cpu(),
                  device.type),
            backend=backend, timeout=3600,
        )
        emit(3, results[0][0])
        emit(4, results[0][1])
    else:
        where = "GPU(s)" if device.type == "cuda" else "CPU rank(s) (--cpu-ranks N asks for N)"
        print(f"configs 3-4 skipped: {ranks or 1} {where}, mesh scenarios need >=2")

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"\n{len(rows)} config rows written to {args.out}")
    print("| config | AUC | MRR | nDCG@5 | nDCG@10 |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| [{r['config']}] {r['description']} | {r['auc']} | {r['mrr']} | {r['ndcg5']} | {r['ndcg10']} |")
    return rows


if __name__ == "__main__":
    main()
