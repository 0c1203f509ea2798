"""Corpus encoding (``ops.encode``: ``encode_corpus``,
``encode_corpus_bucketed``, ``encode_query_and_passage``,
``build_token_store``), the encoder's memory model, the checkpoint readers,
``HFTokenizer`` and ``cli.common.build_encoder``, against the JAX package's
on the same numpy-seeded weights, on the CPU. Vectors and states within
1e-5 in float32 (both sum in float32, in other orders); a float16 store
within half a float16 unit of the float32 states, plus 1e-5."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.cli.common import build_encoder as jax_build_encoder
from news_recommendation_project_v2_tpu.config import EncoderConfig as JaxEncoderConfig
from news_recommendation_project_v2_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer
from news_recommendation_project_v2_tpu.models.news_encoder import NewsEncoder as JaxNewsEncoder
from news_recommendation_project_v2_tpu.models.news_encoder import load_hf_weights as jax_load_hf_weights
from news_recommendation_project_v2_tpu.ops import encode as jax_encode
from news_recommendation_project_v2_tpu.utils import memory as jax_memory
from news_recommendation_project_v2_torch.cli.common import build_encoder
from news_recommendation_project_v2_torch.config import QUERY_INSTRUCTION, EncoderConfig
from news_recommendation_project_v2_torch.data.tokenizer import HFTokenizer
from news_recommendation_project_v2_torch.models.convert import encoder_state_dict_from_jax, random_encoder_params
from news_recommendation_project_v2_torch.models.news_encoder import (
    HashTokenizer,
    NewsEncoder,
    load_hf_weights,
    read_safetensors,
)
from news_recommendation_project_v2_torch.ops.encode import (
    build_token_store,
    encode_corpus,
    encode_corpus_bucketed,
    encode_query_and_passage,
)
from news_recommendation_project_v2_torch.utils.memory import (
    encoder_activation_bytes,
    encoder_float32_bytes,
    estimate_encoder_batch,
    latent_pool_bytes,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

TINY = dict(vocab_size=120, hidden_dim=32, num_layers=2, num_heads=4, intermediate_dim=64, max_position=66,
            compute_dtype="float32")
CFG = EncoderConfig(**TINY)


@pytest.fixture(scope="module")
def pair():
    """The port's encoder and the JAX package's apply functions (pooled and
    hidden states), jitted, on the same weights."""
    params = random_encoder_params(CFG, 0)
    enc = NewsEncoder(CFG).eval()
    enc.load_state_dict(encoder_state_dict_from_jax(params, CFG))
    jenc = JaxNewsEncoder(JaxEncoderConfig(**TINY))
    apply = jax.jit(lambda p, i, m: jenc.apply(p, i, m))
    hidden = jax.jit(lambda p, i, m: jenc.apply(p, i, m, method="hidden_states"))
    return enc, apply, hidden, jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def corpus():
    """37 texts of 1-29 words (3-31 tokens), tokenized 32 wide."""
    rng = np.random.default_rng(0)
    texts = [" ".join(f"w{rng.integers(100)}" for _ in range(int(n))) for n in rng.integers(1, 30, size=37)]
    return texts, *HashTokenizer(vocab_size=CFG.vocab_size, max_length=32)(texts)


def test_encode_corpus_matches_jax(pair, corpus):
    enc, apply, _, params = pair
    _, ids, mask = corpus
    got = encode_corpus(enc, ids, mask, batch_size=8, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (37, CFG.hidden_dim)
    want = np.asarray(jax_encode.encode_corpus(apply, params, ids, mask, batch_size=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("batch_size", [8, None])
def test_encode_corpus_bucketed_matches_jax_and_fixed_width(pair, corpus, batch_size):
    """Each bucket's batch from ``batch_size`` or the memory model (16 GiB
    on the CPU in both packages): equal to the JAX package's bucketed
    encode, and to the fixed-width encode, within 1e-5."""
    enc, apply, _, params = pair
    _, ids, mask = corpus
    got = encode_corpus_bucketed(enc, ids, mask, buckets=(4, 8, 16), batch_size=batch_size, device="cpu").numpy()
    want = jax_encode.encode_corpus_bucketed(
        apply, params, ids, mask, buckets=(4, 8, 16), batch_size=batch_size, encoder_config=JaxEncoderConfig(**TINY)
    )
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    fixed = encode_corpus(enc, ids, mask, batch_size=8, device="cpu").numpy()
    np.testing.assert_allclose(got, fixed, rtol=0, atol=1e-5)


@pytest.mark.parametrize(
    "n, cap, shape",
    [(13, 16, (1, 16)), (16, 16, (1, 16)), (17, 16, (2, 16)), (31, 16, (2, 16)), (0, 16, (1, 8)),
     (23, 12, (2, 12)), (2047, 1976, (2, 1024))],
    ids=["under_cap", "cap", "cap_plus_1", "two_caps_less_1", "empty", "cap_not_multiple_of_8", "moonlight_query"],
)
def test_encode_splits_rows_evenly_over_the_fewest_batches(pair, n, cap, shape):
    """N rows under a batch cap: ceil(N / cap) batches (no rows: one batch
    of 8 pad rows), all of one row count, at most the cap, fewer than 8 pad
    rows a batch where the cap is a multiple of 8 (the last case is
    Moonlight's query bucket: 2,047 rows under the memory model's 1,976 at
    width 64), as ``shape`` (batches, rows) says; the bucketed encode of one
    bucket computes the same batches. The vectors equal the encode at a
    fixed batch of 8 and the JAX package's within 1e-5."""
    enc, apply, _, params = pair
    rng = np.random.default_rng(n)
    ids = rng.integers(3, CFG.vocab_size, (n, 8)).astype(np.int32)
    mask = (np.arange(8)[None, :] < rng.integers(1, 9, n)[:, None]).astype(np.int32)
    fixed = encode_corpus(enc, ids, mask, batch_size=8, device="cpu").numpy()
    if n:
        want = np.asarray(jax_encode.encode_corpus(apply, params, ids, mask, batch_size=8))
        np.testing.assert_allclose(fixed, want, rtol=0, atol=1e-5)
    for encode in (encode_corpus, lambda *a, **k: encode_corpus_bucketed(*a, buckets=(), **k)):
        seen = []
        hook = enc.register_forward_pre_hook(lambda _, args: seen.append(tuple(args[0].shape)))
        try:
            got = encode(enc, ids, mask, batch_size=cap, device="cpu").numpy()
        finally:
            hook.remove()
        batches, rows = len(seen), seen[0][0]
        assert (batches, rows) == shape and batches == max(1, -(-n // cap))
        assert seen == [(rows, 8)] * batches and rows <= cap
        if cap % 8 == 0 and n:
            assert batches * rows - n < 8 * batches
        assert got.shape == (n, CFG.hidden_dim)
        np.testing.assert_allclose(got, fixed, rtol=0, atol=1e-5)


def test_encode_empty_corpus(pair):
    enc = pair[0]
    ids = mask = np.zeros((0, 8), np.int32)
    assert encode_corpus(enc, ids, mask, batch_size=4, device="cpu").shape == (0, CFG.hidden_dim)
    assert encode_corpus_bucketed(enc, ids, mask, buckets=(4,), batch_size=4, device="cpu").shape == (0, CFG.hidden_dim)


@pytest.mark.parametrize("buckets", [None, (8, 16)])
def test_encode_query_and_passage_matches_jax(pair, corpus, buckets):
    """Query first: the instruction-prefixed text, then the passage; both
    tables within 1e-5 of the JAX package's, fixed-width or bucketed."""
    enc, apply, _, params = pair
    texts = corpus[0][:13]
    tok = HashTokenizer(vocab_size=CFG.vocab_size, max_length=64)
    got = encode_query_and_passage(enc, tok, texts, QUERY_INSTRUCTION, batch_size=8, buckets=buckets, device="cpu")
    want = jax_encode.encode_query_and_passage(apply, params, tok, texts, QUERY_INSTRUCTION, 8, buckets=buckets)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert not np.allclose(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("buckets", [None, (4, 8, 16)])
def test_build_token_store_in_ram_matches_jax(pair, corpus, buckets):
    enc, _, hidden, params = pair
    _, ids, mask = corpus
    got = build_token_store(enc, ids, mask, batch_size=8, token_buckets=buckets, device="cpu")
    want = jax_encode.build_token_store(hidden, params, ids, mask, batch_size=8, token_buckets=buckets)
    assert np.array_equal(got.offsets, want.offsets) and got.offsets[-1] == mask.sum()
    assert got.states.dtype == np.float32
    np.testing.assert_allclose(got.states, want.states, rtol=0, atol=1e-5)


def test_build_token_store_to_disk_in_float16(pair, corpus, tmp_path):
    """Streamed into ``out_dir``: the states.npy memmap and offsets.npy of the
    JAX package's store, reopened read-only; float16 within half a float16
    unit (2^-11 relative) plus 1e-5 of the JAX package's float32 states."""
    enc, _, hidden, params = pair
    _, ids, mask = corpus
    got = build_token_store(enc, ids, mask, batch_size=8, out_dir=tmp_path / "s", store_dtype=np.float16, device="cpu")
    want = jax_encode.build_token_store(hidden, params, ids, mask, batch_size=8)
    assert isinstance(got.states, np.memmap) and got.states.dtype == np.float16 and not got.states.flags.writeable
    assert np.array_equal(got.offsets, want.offsets)
    assert np.array_equal(np.load(tmp_path / "s" / "offsets.npy"), want.offsets)
    err = np.abs(got.states.astype(np.float32) - want.states)
    assert (err <= 2.0**-11 * np.abs(want.states) + 1e-5).all()


def test_build_token_store_empty_corpus(pair, tmp_path):
    enc = pair[0]
    ids = mask = np.zeros((0, 8), np.int32)
    store = build_token_store(enc, ids, mask, out_dir=tmp_path / "e", device="cpu")
    assert store.num_items == 0 and store.states.shape[0] == 0


@pytest.mark.parametrize("budget", [16 * 1024**3, 80 * 10**9])
@pytest.mark.parametrize("length", [None, 32, 512])
@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_encoder_memory_model_matches_jax(budget, length, compute):
    """The block's envelope is the JAX package's; the port adds what stays
    float32 in any compute type (``encoder_float32_bytes``; these layouts
    have no latent-pool head), so its batch is its own envelope's and at
    most the JAX package's."""
    for kw in ({}, dict(arch="qwen2", hidden_dim=4096, num_heads=32, intermediate_dim=14336)):
        cfg, jcfg = EncoderConfig(compute_dtype=compute, **kw), JaxEncoderConfig(compute_dtype=compute, **kw)
        width = length or cfg.max_length
        assert latent_pool_bytes(cfg, 64, width, 2) == 0
        for batch in (1, 64):
            want = jax_memory.encoder_activation_bytes(jcfg, batch, length) + encoder_float32_bytes(cfg, batch, width)
            assert encoder_activation_bytes(cfg, batch, length) == want
        want = jax_memory.encoder_activation_bytes(jcfg, 8, length, 4) + encoder_float32_bytes(cfg, 8, width)
        assert encoder_activation_bytes(cfg, 8, length, 4) == want
        got = estimate_encoder_batch(cfg, length, hbm_budget_bytes=budget)
        assert got == max(8, int(budget * 0.25) // encoder_activation_bytes(cfg, 1, length) // 8 * 8)
        assert got <= jax_memory.estimate_encoder_batch(jcfg, length, hbm_budget_bytes=budget)


def _tensors():
    rng = np.random.default_rng(5)
    return {
        "w": rng.standard_normal((3, 5)).astype(np.float32),
        "h": rng.standard_normal((7,)).astype(np.float16),
        "i": np.arange(6, dtype=np.int64).reshape(2, 3),
        "scalar": np.array(2.5, np.float64),
        "empty": np.zeros((0, 4), np.float32),
    }


def test_safetensors_reader_matches_the_package(tmp_path):
    """The port's own reader against ``safetensors.numpy.load_file`` (types
    and values), and bfloat16 against ``safetensors.torch.load_file``."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    st_torch = pytest.importorskip("safetensors.torch")
    st_numpy.save_file(_tensors(), str(tmp_path / "a.safetensors"), metadata={"format": "np"})
    got, want = read_safetensors(tmp_path / "a.safetensors"), st_numpy.load_file(str(tmp_path / "a.safetensors"))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k
    bf = {"b": torch.randn(4, 6, generator=torch.Generator().manual_seed(0)).bfloat16()}
    st_torch.save_file(bf, str(tmp_path / "b.safetensors"))
    got = read_safetensors(tmp_path / "b.safetensors")["b"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, st_torch.load_file(str(tmp_path / "b.safetensors"))["b"])


@pytest.mark.parametrize("layout", ["single", "sharded", "bin", "file"])
def test_load_hf_weights_matches_jax(tmp_path, layout):
    """One safetensors file, a sharded index, ``pytorch_model.bin``, a file
    path: the same values as the JAX package's reader, floating tensors as
    float32 (integer ones keep their type; the JAX package's ``.bin`` reader
    makes them float32 too)."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    tensors = {k: v for k, v in _tensors().items() if v.dtype != np.float64}
    if layout in ("single", "file"):
        st_numpy.save_file(tensors, str(tmp_path / "model.safetensors"))
    elif layout == "sharded":
        names = sorted(tensors)
        shards = {"model-1.safetensors": names[:2], "model-2.safetensors": names[2:]}
        for shard, keys in shards.items():
            st_numpy.save_file({k: tensors[k] for k in keys}, str(tmp_path / shard))
        weight_map = {k: s for s, keys in shards.items() for k in keys}
        (tmp_path / "model.safetensors.index.json").write_text(json.dumps({"weight_map": weight_map}))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()}, tmp_path / "pytorch_model.bin")
    path = tmp_path / "model.safetensors" if layout == "file" else tmp_path
    got, want = load_hf_weights(path), jax_load_hf_weights(path)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == (np.float32 if tensors[k].dtype.kind == "f" else tensors[k].dtype)
        assert np.array_equal(g, np.asarray(w).astype(g.dtype)), k


def _tokenizer_json(path):
    """A tiny XLM-R-style Unigram tokenizer (<s>=0 <pad>=1 </s>=2) saved as
    tokenizer.json, as tests/test_tokenizer.py builds it."""
    tokenizers = pytest.importorskip("tokenizers")
    tok = tokenizers.Tokenizer(tokenizers.models.Unigram())
    tok.pre_tokenizer = tokenizers.pre_tokenizers.Metaspace()
    trainer = tokenizers.trainers.UnigramTrainer(
        vocab_size=100, special_tokens=["<s>", "<pad>", "</s>", "<unk>"], unk_token="<unk>"
    )
    tok.train_from_iterator(["Title: stock markets rally", "Title: heavy rain this weekend"] * 30, trainer)
    tok.post_processor = tokenizers.processors.TemplateProcessing(
        single="<s> $A </s>", special_tokens=[("<s>", tok.token_to_id("<s>")), ("</s>", tok.token_to_id("</s>"))]
    )
    tok.save(str(path / "tokenizer.json"))
    return path / "tokenizer.json"


TEXTS = ["Title: stock markets rally", "Title: heavy rain this weekend " * 4, "zebra"]


def test_hf_tokenizer_matches_jax(tmp_path):
    f = _tokenizer_json(tmp_path)
    for max_length in (None, 6):
        got = HFTokenizer.from_file(f, max_length=16)(TEXTS, max_length)
        want = JaxHFTokenizer.from_file(f, max_length=16)(TEXTS, max_length)
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert HFTokenizer.from_dir(tmp_path).pad_id == 1


def test_build_encoder_from_a_checkpoint_matches_jax(tmp_path):
    """An HF directory (config.json of an XLM-R, model.safetensors under the
    ``roberta.`` prefix, tokenizer.json): raw text to vectors within 1e-5 of
    the JAX package's ``build_encoder`` on the same directory."""
    st_numpy = pytest.importorskip("safetensors.numpy")
    vocab = HFTokenizer.from_file(_tokenizer_json(tmp_path)).vocab_size
    cfg = EncoderConfig(**{**TINY, "vocab_size": vocab})
    sd = encoder_state_dict_from_jax(random_encoder_params(cfg, 1), cfg)
    st_numpy.save_file({f"roberta.{k}": v.numpy() for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    hf = dict(architectures=["XLMRobertaForMaskedLM"], vocab_size=vocab, hidden_size=32, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=64, max_position_embeddings=66, layer_norm_eps=1e-5)
    (tmp_path / "config.json").write_text(json.dumps(hf))
    enc, tok = build_encoder(tmp_path, max_length=16, compute_dtype="float32", device="cpu")
    assert isinstance(tok, HFTokenizer) and enc.config.pooling == "mean" and not enc.training
    jenc, jtok, params = jax_build_encoder(tmp_path, max_length=16, compute_dtype="float32")
    ids, mask = tok(TEXTS)
    with torch.no_grad():
        got = enc(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    want = np.asarray(jenc.apply(params, jnp.asarray(ids), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_build_encoder_errors_and_random_weights(tmp_path):
    """Both a checkpoint and a config raise; a checkpoint without
    tokenizer.json raises unless the hash tokenizer is allowed, as in the
    JAX package. Without a checkpoint: seeded random weights (two builds
    of one seed equal, another seed not) and a HashTokenizer."""
    with pytest.raises(ValueError, match="pass either hf_checkpoint or encoder_config"):
        build_encoder(tmp_path, CFG, device="cpu")
    with pytest.raises(FileNotFoundError, match="has no tokenizer.json"):
        build_encoder(tmp_path, device="cpu")
    a, tok = build_encoder(encoder_config=CFG, max_length=16, device="cpu")
    b, _ = build_encoder(encoder_config=CFG, max_length=16, device="cpu")
    c, _ = build_encoder(encoder_config=CFG, max_length=16, seed=1, device="cpu")
    assert isinstance(tok, HashTokenizer) and tok.max_length == 16
    ids, mask = tok(TEXTS)
    with torch.no_grad():
        outs = [m(torch.from_numpy(ids), torch.from_numpy(mask)) for m in (a, b, c)]
    assert torch.equal(outs[0], outs[1]) and not torch.allclose(outs[0], outs[2])
    np.testing.assert_allclose(outs[0].norm(dim=-1).numpy(), 1.0, atol=1e-5)
