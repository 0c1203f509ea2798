"""End-to-end training CLI (config[2]): transform -> the frozen encoder's
token states -> a learned token-attention encoder and the latent tower
trained together on the with-history rows, then the tower's scores over
the learned news embeddings.

    nrtorch-train-e2e DATA_DIR --dataset MINDsmall_train --epochs 5
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..config import DataSubset, NewsDataset, TowerConfig, TrainConfig
from ..models import TokenAttentionPool, build_tower
from ..models.convert import e2e_state_dict_from_jax, random_e2e_params
from ..pipeline import (
    AttentionAttentionComponent,
    FinalAttentionComponent,
    Pipeline,
    StoreTokenStatesComponent,
    TransformDataComponent,
)
from .common import add_device_argument, build_context, build_encoder, log_final_scores, tiny_encoder_config


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("data_dir", type=Path)
    parser.add_argument("--dataset", default="MINDsmall_train", choices=NewsDataset._member_names_)
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-6)
    parser.add_argument("--dim", type=int, default=128)
    parser.add_argument("--max-length", type=int, default=64)
    parser.add_argument("--log-dir", type=Path, default=Path("logs"))
    parser.add_argument("--ckpt-dir", type=Path, default=Path("models"))
    parser.add_argument("--exp-name", default="attn_attn")
    parser.add_argument("--hf-checkpoint", type=Path, default=None)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    dataset = NewsDataset[args.dataset]
    enc, tok = build_encoder(
        args.hf_checkpoint, tiny_encoder_config(args.max_length, args.dim), args.max_length, device=args.device
    )
    # The frozen encoder's unpooled states feed the token store; a one-layer
    # learned token-attention encoder and the latent tower train on them.
    cfg = TrainConfig(learning_rate=args.lr, num_epochs=args.epochs, batch_size=args.batch_size)
    tower_cfg = TowerConfig(
        kind="latent", reduced_dim=args.dim, num_latents=min(64, args.dim), latent_dim_head=max(8, args.dim // 2)
    )
    model = torch.nn.ModuleDict(
        {"token_encoder": TokenAttentionPool(hidden_size=args.dim, num_layers=1), "tower": build_tower(tower_cfg)}
    )
    model.load_state_dict(
        e2e_state_dict_from_jax(random_e2e_params(np.random.default_rng(cfg.seed), args.dim, 1, tower_cfg))
    )
    e2e = AttentionAttentionComponent(
        model["token_encoder"],
        model["tower"],
        cfg=cfg,
        log_dir=args.log_dir,
        ckpt_dir=args.ckpt_dir / "attn_attn",
        exp_name=args.exp_name,
        max_token_len=args.max_length,
        device=args.device,
    )
    pipe = Pipeline(
        name=f"train_e2e_{args.exp_name}",
        steps=[
            ("transform", TransformDataComponent()),
            ("store_tokens", StoreTokenStatesComponent(enc, tok, batch_size=16, device=args.device)),
            ("attn_attn", e2e),
        ],
        use_cache=False,
    )
    context = build_context(args.data_dir, dataset, data_subset=DataSubset.WITH_HISTORY)
    context, _ = pipe.train(context)

    # Score with the learned embeddings (the tower alone, with-history rows).
    scorer = FinalAttentionComponent(tower_config=tower_cfg, exp_name=args.exp_name, device=args.device)
    scorer.tower, scorer.initialised = e2e._trainer.tower, True
    context = scorer.transform(context)
    log_final_scores(args.log_dir, args.exp_name, context.get("metrics"), None)
    print("metrics:", context.get("metrics"))
    return context


if __name__ == "__main__":
    main()
