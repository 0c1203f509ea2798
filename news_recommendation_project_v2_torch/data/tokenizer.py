"""Text tokenization for the news encoder from a checkpoint's
``tokenizer.json``, through the ``tokenizers`` engine that every HF "fast"
tokenizer runs: the same token ids as the reference's ``AutoTokenizer``
without the ``transformers`` runtime. Output is padded to a fixed length.

``models.news_encoder.HashTokenizer`` is for synthetic text only: nothing
here falls back to it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

TOKENIZER_JSON = "tokenizer.json"


class HFTokenizer:
    """Fixed-length tokenization over a ``tokenizers.Tokenizer``: ``__call__``
    returns ``(ids [B, T] int32, mask [B, T] int32)``, the real tokens as
    ``transformers``' fast tokenizer gives them with ``truncation=True,
    max_length=T``, then ``pad_id``."""

    def __init__(self, tokenizer, max_length: int = 512, pad_id: Optional[int] = None):
        self._tok = tokenizer
        self.max_length = max_length
        if pad_id is None:
            for cand in ("<pad>", "[PAD]", "<|endoftext|>"):
                t = tokenizer.token_to_id(cand)
                if t is not None:
                    pad_id = t
                    break
        # XLM-R's convention (<s>=0 <pad>=1 </s>=2) when the vocabulary names no pad.
        self.pad_id = 1 if pad_id is None else int(pad_id)
        self.vocab_size = int(tokenizer.get_vocab_size())

    @classmethod
    def from_file(cls, path: Path, max_length: int = 512, pad_id: Optional[int] = None) -> "HFTokenizer":
        try:
            from tokenizers import Tokenizer
        except ImportError as e:
            raise ImportError(
                "HFTokenizer reads tokenizer.json with the `tokenizers` package, which is "
                "not installed; install it (pip install tokenizers). No other tokenizer "
                "stands in for a checkpoint's own."
            ) from e
        return cls(Tokenizer.from_file(str(path)), max_length, pad_id)

    @classmethod
    def from_dir(cls, path: Path, max_length: int = 512, pad_id: Optional[int] = None) -> "HFTokenizer":
        """From an HF checkpoint directory's ``tokenizer.json``."""
        f = Path(path) / TOKENIZER_JSON
        if not f.exists():
            raise FileNotFoundError(
                f"{f} not found: the checkpoint has no fast-tokenizer file. "
                "Export one with tokenizer.save_pretrained(...) (any HF fast "
                "tokenizer writes tokenizer.json)."
            )
        return cls.from_file(f, max_length, pad_id)

    def __call__(self, texts: Sequence[str], max_length: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        T = max_length or self.max_length
        # Truncation is state on the Rust side: set it on every call.
        self._tok.enable_truncation(max_length=T)
        self._tok.no_padding()
        encodings = self._tok.encode_batch(list(texts))
        ids = np.full((len(texts), T), self.pad_id, dtype=np.int32)
        mask = np.zeros((len(texts), T), dtype=np.int32)
        for i, enc in enumerate(encodings):
            n = len(enc.ids)
            ids[i, :n] = enc.ids
            mask[i, :n] = 1
        return ids, mask


def has_tokenizer_file(path: Path) -> bool:
    return (Path(path) / TOKENIZER_JSON).exists()
