"""Shared CLI plumbing: the news encoder and its tokenizer."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import torch

from ..config import EncoderConfig
from ..device import resolve_device
from ..models import DTYPES
from ..models.convert import encoder_state_dict_from_hf
from ..models.news_encoder import (
    HashTokenizer,
    NewsEncoder,
    encoder_config_from_hf,
    init_random_weights,
    load_hf_weights,
)


def build_encoder(
    hf_checkpoint: Optional[Path] = None,
    encoder_config: Optional[EncoderConfig] = None,
    max_length: int = 128,
    allow_hash_tokenizer: bool = False,
    compute_dtype: Optional[str] = None,
    seed: int = 0,
    device=None,
) -> tuple[NewsEncoder, object]:
    """The news encoder on ``device`` (``None``: CUDA) in eval mode, and its
    tokenizer.

    With ``hf_checkpoint`` (an HF model directory) everything comes from the
    checkpoint, as the reference's ``AutoModel``/``AutoTokenizer`` pair
    takes it: the layout and pooling from ``config.json``
    (``encoder_config_from_hf``; a bare weights file assumes e5's), the
    weights from safetensors (one file or sharded) or ``pytorch_model.bin``
    (``load_hf_weights``), the tokenizer from ``tokenizer.json``
    (``HFTokenizer``). A checkpoint without ``tokenizer.json`` raises unless
    ``allow_hash_tokenizer``: real weights read hash token ids as noise.

    Without one: ``encoder_config`` (default e5-large) with seeded random
    weights drawn on the device (``init_random_weights``) and a
    ``HashTokenizer``, for synthetic text. ``compute_dtype`` overrides the
    config's."""
    device = resolve_device(device)
    path = Path(hf_checkpoint) if hf_checkpoint is not None else None
    if path is not None and encoder_config is not None:
        raise ValueError(
            "pass either hf_checkpoint or encoder_config, not both: an "
            "explicit EncoderConfig would silently mismatch checkpoint layers"
        )
    if path is not None and path.is_dir() and (path / "config.json").exists():
        cfg = encoder_config_from_hf(json.loads((path / "config.json").read_text()))
    elif path is not None:
        cfg = EncoderConfig()  # a bare weights file: e5's geometry
    else:
        cfg = encoder_config or EncoderConfig()
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)

    if path is None:
        with torch.device(device):
            enc = init_random_weights(NewsEncoder(cfg), seed)
        return enc.eval(), HashTokenizer(vocab_size=cfg.vocab_size, max_length=max_length)

    from ..data.tokenizer import HFTokenizer, has_tokenizer_file

    if path.is_dir() and has_tokenizer_file(path):
        tok = HFTokenizer.from_dir(path, max_length=max_length)
    elif allow_hash_tokenizer:
        tok = HashTokenizer(vocab_size=cfg.vocab_size, max_length=max_length)
    else:
        raise FileNotFoundError(
            f"{path} has no tokenizer.json: real encoder weights with hash "
            "token ids produce garbage embeddings. Export the checkpoint "
            "with tokenizer.save_pretrained(...), or pass "
            "allow_hash_tokenizer=True for synthetic-data use."
        )
    with torch.device("meta"):
        enc = NewsEncoder(cfg)
    enc.load_state_dict(encoder_state_dict_from_hf(load_hf_weights(path), cfg), assign=True)
    return enc.to(device, DTYPES[cfg.param_dtype]).eval(), tok
