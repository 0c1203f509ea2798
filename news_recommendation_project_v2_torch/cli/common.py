"""Shared CLI plumbing: a dataset's pipeline context, the news encoder and
its tokenizer, and the final scores' log."""

from __future__ import annotations

import dataclasses
import json
from datetime import datetime
from pathlib import Path
from typing import Optional

import torch

from ..config import DataSubset, EncoderConfig, NewsDataset
from ..data.ingest import load_dataset
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


def build_context(
    data_dir: Path,
    dataset: NewsDataset,
    data_subset: DataSubset = DataSubset.ALL,
    num_samples: Optional[int] = None,
) -> dict:
    """The entry context of a pipeline run over ``dataset``'s processed
    store (``data.ingest.load_dataset``): the behaviors rows, the news
    texts, the dataset's name and the per-news category and entity
    features."""
    ds = load_dataset(data_dir, dataset, num_samples=num_samples, data_subset=data_subset)
    return {
        "behaviors": ds.behaviors,
        "news_text_dict": ds.news_text,
        "dataset_name": dataset.value,
        "news_category": ds.news_category,
        "news_subcategory": ds.news_subcategory,
        "news_title_entity": ds.news_title_entity,
        "news_abstract_entity": ds.news_abstract_entity,
    }


def tiny_encoder_config(max_length: int, dim: int = 128) -> EncoderConfig:
    """A small random BERT-layout encoder for offline and synthetic runs: a
    5,003-word vocabulary, 2 layers of 4 heads at ``dim``, an MLP of
    ``2 * dim``."""
    return EncoderConfig(
        vocab_size=5003,
        hidden_dim=dim,
        num_layers=2,
        num_heads=4,
        intermediate_dim=2 * dim,
        max_position=max_length + 2,
    )


def add_device_argument(parser) -> None:
    parser.add_argument(
        "--device",
        default=None,
        help="torch device (default: cuda; cpu runs the kernels' plain versions)",
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


def log_final_scores(
    log_dir: Path, exp_name: str, train_metrics: Optional[dict], val_metrics: Optional[dict]
) -> None:
    """Append a run's final metrics to ``log_dir/final_scores.jsonl``."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with open(log_dir / "final_scores.jsonl", "a") as f:
        f.write(
            json.dumps(
                {
                    "timestamp": datetime.now().isoformat(),
                    "exp_name": exp_name,
                    "train_scores": train_metrics,
                    "eval_scores": val_metrics,
                }
            )
            + "\n"
        )
