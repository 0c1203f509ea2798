"""Embedding precompute CLI: transform -> encode -> save the query and
passage tables of a split, keyed by news id (the dump ``nrtorch-train``,
``nrtorch-eval`` and ``nrtorch-serve`` read).

    nrtorch-save-emb DATA_DIR MINDsmall_train --save-dir embeddings
    nrtorch-save-emb DATA_DIR MINDsmall_train --save-dir embeddings --tiny-encoder --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..config import QUERY_INSTRUCTION, NewsDataset
from ..pipeline import EmbeddingsComponent, Pipeline, SaveEmbeddingComponent, TransformDataComponent
from .common import add_device_argument, build_context, build_encoder, tiny_encoder_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("news_dataset", choices=NewsDataset._member_names_)
    parser.add_argument("--save-dir", type=Path, default=Path("embeddings"))
    parser.add_argument("--hf-checkpoint", type=Path, default=None)
    parser.add_argument(
        "--batch-size",
        type=int,
        default=0,
        help="0 (default) sizes the encode batch from the memory model",
    )
    parser.add_argument("--max-length", type=int, default=128)
    parser.add_argument(
        "--tiny-encoder",
        action="store_true",
        help="small random encoder (offline/synthetic mode)",
    )
    add_device_argument(parser)
    args = parser.parse_args(argv)
    dataset = NewsDataset[args.news_dataset]

    enc_cfg = tiny_encoder_config(args.max_length) if args.tiny_encoder else None
    enc, tok = build_encoder(args.hf_checkpoint, enc_cfg, args.max_length, device=args.device)
    pipe = Pipeline(
        name=f"save_emb_{dataset.value}",
        steps=[
            ("transform", TransformDataComponent()),
            (
                "embed",
                EmbeddingsComponent(
                    enc,
                    tok,
                    QUERY_INSTRUCTION,
                    args.batch_size or None,  # 0 -> the memory model's batch
                    device=args.device,
                ),
            ),
            ("save", SaveEmbeddingComponent(args.save_dir, dataset.value)),
        ],
        use_cache=False,
    )
    context, _ = pipe.transform(build_context(args.data_dir, dataset))
    emb = context["news_embeddings"]
    print(
        f"saved {emb.shape} embeddings to {args.save_dir} "
        f"(unit-norm: {bool(np.allclose(np.linalg.norm(emb, axis=1), 1, atol=1e-3))})"
    )
    return context


if __name__ == "__main__":
    main()
