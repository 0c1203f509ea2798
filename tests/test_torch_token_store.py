"""The port's token store and its materialization (``ops.encode``:
``TokenStore``, ``materialize_from_token_store``) against the JAX package's
on the same numpy-seeded states, on the CPU: the padded gathers and index
grids array for array, the directory format read by either package from
either, a float16 store, the reference SQLite import in RAM and out of core,
and the learned encoder's embeddings over both routes within 1e-5 (both
sum in float32, in other orders)."""

import io
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.config import bucket_for_open as jax_bucket_for_open
from news_recommendation_project_v2_tpu.models import TokenAttentionPool as JaxTokenAttentionPool
from news_recommendation_project_v2_tpu.ops.encode import TokenStore as JaxTokenStore
from news_recommendation_project_v2_tpu.ops.encode import materialize_from_token_store as jax_materialize
from news_recommendation_project_v2_torch.config import bucket_for_open
from news_recommendation_project_v2_torch.models import TokenAttentionPool, convert
from news_recommendation_project_v2_torch.ops.encode import TokenStore, materialize_from_token_store
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

D = 16


def _arrays(seed: int, n: int = 23, lo: int = 1, hi: int = 11, dtype=np.float32) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(lo, hi)), D)).astype(dtype) for _ in range(n)]


def _stores(arrays):
    return TokenStore.from_ragged(arrays), JaxTokenStore.from_ragged(arrays)


@pytest.mark.parametrize("length", [1, 64, 65, 512, 513, 1100])
def test_bucket_for_open_matches_jax(length):
    buckets = (64, 128, 256, 512)
    assert bucket_for_open(length, buckets) == jax_bucket_for_open(length, buckets)


@pytest.mark.parametrize("max_len", [None, 4])
def test_gather_padded_matches_jax(max_len):
    port, jax_store = _stores(_arrays(0))
    idx = np.array([4, 0, 17, 4, 22])
    got, want = port.gather_padded(idx, max_len=max_len), jax_store.gather_padded(idx, max_len=max_len)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert port.num_items == 23 and np.array_equal(port.lengths(), jax_store.lengths())


@pytest.mark.parametrize("T,out_rows,max_len", [(8, None, None), (16, 9, None), (4, 12, 3)])
def test_padded_index_batch_matches_jax(T, out_rows, max_len):
    """Pad slots at row 0, rows past the indices with mask slot 0 live."""
    port, jax_store = _stores(_arrays(1))
    idx = np.array([3, 9, 0, 21, 9])
    got = port.padded_index_batch(idx, T, out_rows=out_rows, max_len=max_len)
    want = jax_store.padded_index_batch(idx, T, out_rows=out_rows, max_len=max_len)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if out_rows:
        assert (got[1][len(idx) :, 0] == 1).all() and not got[1][len(idx) :, 1:].any()


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_store_directory_opens_in_either_package(tmp_path, dtype):
    """``save_dir`` by one package, ``open_dir`` (memmap) by the other, both
    ways, equal arrays and types; the files are the same bytes; the
    ``.npz`` form round-trips."""
    arrays = _arrays(2, dtype=dtype)
    port, jax_store = _stores(arrays)
    port.save_dir(tmp_path / "port")
    jax_store.save_dir(tmp_path / "jax")
    for name in ("states.npy", "offsets.npy"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for opened in (JaxTokenStore.open_dir(tmp_path / "port"), TokenStore.open_dir(tmp_path / "jax")):
        assert isinstance(opened.states, np.memmap) and opened.states.dtype == dtype
        assert np.array_equal(opened.states, port.states) and np.array_equal(opened.offsets, port.offsets)
    port.save(tmp_path / "s.npz")
    back = JaxTokenStore.load(tmp_path / "s.npz")
    assert back.states.dtype == dtype and np.array_equal(back.states, port.states)
    got = TokenStore.open_dir(tmp_path / "jax").gather_padded(np.array([5, 1]))
    want = jax_store.gather_padded(np.array([5, 1]))
    assert got[0].dtype == want[0].dtype == dtype
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def _write_reference_db(path, arrays):
    """The reference's writer: one torch-pickled [L_i, D] tensor a row, ids
    1..N in order."""
    with sqlite3.connect(path) as conn:
        conn.execute("CREATE TABLE tensors (id INTEGER PRIMARY KEY, data BLOB)")
        for a in arrays:
            buf = io.BytesIO()
            torch.save(torch.from_numpy(a), buf)
            conn.execute("INSERT INTO tensors (data) VALUES (?)", (buf.getvalue(),))


@pytest.mark.parametrize("out_of_core", [False, True], ids=["in_ram", "out_of_core"])
@pytest.mark.parametrize("dtype", [None, np.float16])
def test_reference_sqlite_import_matches_jax(tmp_path, out_of_core, dtype):
    arrays = _arrays(3, n=17)
    db = tmp_path / "mydb_train.sqlite"
    _write_reference_db(db, arrays)
    port = TokenStore.from_reference_sqlite(db, out_dir=tmp_path / "port" if out_of_core else None, dtype=dtype)
    want = JaxTokenStore.from_reference_sqlite(db, out_dir=tmp_path / "jax" if out_of_core else None, dtype=dtype)
    assert isinstance(port.states, np.memmap) == out_of_core
    assert port.states.dtype == want.states.dtype == np.dtype(dtype or np.float32)
    assert np.array_equal(port.states, want.states) and np.array_equal(port.offsets, want.offsets)
    assert np.array_equal(port.states, np.concatenate(arrays).astype(dtype or np.float32))
    if out_of_core:
        for name in ("states.npy", "offsets.npy"):
            assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_reference_sqlite_import_refuses_gaps_and_empty_dbs(tmp_path):
    db = tmp_path / "gap.sqlite"
    _write_reference_db(db, _arrays(4, n=3))
    with sqlite3.connect(db) as conn:
        conn.execute("DELETE FROM tensors WHERE id = 2")
    with pytest.raises(ValueError, match="non-contiguous"):
        TokenStore.from_reference_sqlite(db)
    empty = tmp_path / "empty.sqlite"
    _write_reference_db(empty, [])
    for out_dir in (None, tmp_path / "ooc"):
        with pytest.raises(ValueError, match="empty"):
            TokenStore.from_reference_sqlite(empty, out_dir=out_dir)
    assert not (tmp_path / "ooc" / "offsets.npy").exists()


def _encoder(seed: int = 5):
    params = convert.random_token_attention_pool_params(np.random.default_rng(seed), D, 1)
    enc = TokenAttentionPool(hidden_size=D, num_layers=1)
    enc.load_state_dict(convert.token_attention_pool_state_dict_from_jax(params), strict=True)
    return enc, params


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("route", ["host", "device"])
@pytest.mark.parametrize("batch_size,max_len", [(8, 512), (None, 6)])
def test_materialize_matches_jax(route, batch_size, max_len, dtype):
    """Both routes (``dev_states``: the flat states as a tensor, gathered by
    index grids) against the JAX package's, within 1e-5; a float16 store
    is cast to float32 before the encoder in both. Dropout is off in both
    (no generator; the flax module's default ``deterministic``)."""
    arrays = _arrays(6, n=37, hi=14, dtype=dtype)
    port, jax_store = _stores(arrays)
    enc, params = _encoder()
    dev = torch.from_numpy(port.states) if route == "device" else None
    got = materialize_from_token_store(
        enc, port, batch_size=batch_size, max_token_len=max_len, token_buckets=(4, 8), dev_states=dev, device="cpu"
    )
    want = jax_materialize(
        JaxTokenAttentionPool(hidden_size=D, num_layers=1).apply, params,
        jax_store, batch_size=batch_size, max_token_len=max_len, token_buckets=(4, 8),
        dev_states=jnp.asarray(jax_store.states) if route == "device" else None,
    )
    assert got.shape == (37, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_materialize_routes_agree_on_a_float16_store():
    """A float16 store: the device route gathers float16 rows and casts them
    on the card, the host route casts the gathered block; same values."""
    port = TokenStore.from_ragged(_arrays(7, n=20, dtype=np.float16))
    enc, _ = _encoder()
    host = materialize_from_token_store(enc, port, batch_size=8, device="cpu")
    dev = materialize_from_token_store(
        enc, port, batch_size=8, dev_states=torch.from_numpy(port.states), device="cpu"
    )
    assert np.array_equal(host, dev) and np.isfinite(host).all()
