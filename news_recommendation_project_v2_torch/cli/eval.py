"""Eval CLI: transform -> the split's embedding dump -> the user tower's
scores from a checkpoint (a ``Best_model_*`` or ``Epoch_N`` of
``nrtorch-train``) over the with-history rows, the metrics logged.

    nrtorch-eval DATA_DIR --dataset MINDsmall_dev --emb-dir embeddings \
        --ckpt models/attention/Best_model_e5_query_latent
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..config import DataSubset, NewsDataset, TowerConfig, tower_kwargs_for_dim
from ..pipeline import FinalAttentionComponent, Pipeline, TransformDataComponent
from .common import add_device_argument, build_context, log_final_scores
from .train import _PerSplitLoad


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("--dataset", default="MINDsmall_dev", choices=NewsDataset._member_names_)
    parser.add_argument("--emb-dir", type=Path, default=Path("embeddings"))
    parser.add_argument("--ckpt", type=Path, default=None)
    parser.add_argument("--tower", default="latent", choices=["latent", "final_attention", "transformer"])
    parser.add_argument("--dim", type=int, default=None)
    parser.add_argument("--log-dir", type=Path, default=Path("logs"))
    parser.add_argument("--exp-name", default="eval")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    dataset = NewsDataset[args.dataset]
    pipe = Pipeline(
        name=f"eval_{args.exp_name}",
        steps=[
            ("transform", TransformDataComponent()),
            ("load_embedding", _PerSplitLoad(args.emb_dir)),
            (
                "final_attention",
                FinalAttentionComponent(
                    tower_config=TowerConfig(kind=args.tower, **tower_kwargs_for_dim(args.dim)),
                    warm_start=args.ckpt,
                    exp_name=args.exp_name,
                    device=args.device,
                ),
            ),
        ],
        use_cache=False,
    )
    context, _ = pipe.transform(build_context(args.data_dir, dataset, data_subset=DataSubset.WITH_HISTORY))
    log_final_scores(args.log_dir, args.exp_name, None, context.get("metrics"))
    print("metrics:", context.get("metrics"))
    return context


if __name__ == "__main__":
    main()
