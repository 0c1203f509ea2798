"""The port's kernel modules against the JAX package's kernels.

On the CPU the wrappers compute their plain PyTorch versions; those are held
against the JAX plain references and the Pallas kernels (interpret mode), on
the same numpy-seeded inputs. The CUDA kernels themselves are held against
the plain versions in ``test_torch_cuda.py``, which skips without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from news_recommendation_project_v2_tpu.ops.pallas_attention import (
    _reference_attention,
    fused_latent_attention,
)
from news_recommendation_project_v2_tpu.ops.pallas_geglu import fused_geglu
from news_recommendation_project_v2_tpu.ops.pallas_geglu import (
    reference_geglu as jax_reference_geglu,
)
from news_recommendation_project_v2_torch.ops import _build
from news_recommendation_project_v2_torch.ops.geglu import geglu, reference_geglu
from news_recommendation_project_v2_torch.ops.latent_attention import (
    latent_attention,
    reference_attention,
)
from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

B, H, L, N, DH = 3, 2, 16, 8, 32
C, D, F = 512, 128, 512


@pytest.fixture
def qkv(rng):
    return (
        rng.standard_normal((B, H, L, DH)).astype(np.float32),
        rng.standard_normal((H, N, DH)).astype(np.float32),
        rng.standard_normal((H, N, DH)).astype(np.float32),
    )


@pytest.fixture
def ffn(rng):
    """x and the GEGLU weights in the JAX layout ([in, out] kernels)."""
    return (
        rng.standard_normal((C, D)).astype(np.float32),
        (rng.standard_normal((D, 2 * F)) * 0.05).astype(np.float32),
        (rng.standard_normal(2 * F) * 0.05).astype(np.float32),
        (rng.standard_normal((F, D)) * 0.05).astype(np.float32),
        (rng.standard_normal(D) * 0.05).astype(np.float32),
    )


def _port_ffn(ffn):
    """The same weights in nn.Linear layout, as torch tensors."""
    x, w_in, b_in, w_out, b_out = ffn
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, w_in.T, b_in, w_out.T, b_out))


@pytest.mark.parametrize(
    "oracle",
    [_reference_attention, jax.jit(fused_latent_attention)],
    ids=["reference", "pallas_interpret"],
)
def test_plain_attention_matches_jax(qkv, oracle):
    got = reference_attention(*(torch.from_numpy(a) for a in qkv)).numpy()
    want = np.asarray(oracle(*(jnp.asarray(a) for a in qkv)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize(
    "oracle",
    [jax_reference_geglu, jax.jit(lambda *a: fused_geglu(*a, block_c=256, block_k=128))],
    ids=["reference", "pallas_interpret"],
)
def test_plain_geglu_matches_jax(ffn, oracle):
    got = reference_geglu(*_port_ffn(ffn)).numpy()
    want = np.asarray(oracle(*(jnp.asarray(a) for a in ffn)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_plain_geglu_rounds_gate_like_pallas_in_bf16(ffn):
    """bfloat16 inputs: the gated product is rounded to bfloat16 before
    W_out (the Pallas kernel's dtype chain); products stay float32. The two
    sum in other orders, so a gate value may round one bfloat16 unit apart."""
    bf = tuple(t.to(torch.bfloat16) for t in _port_ffn(ffn))
    got = reference_geglu(*bf).numpy()
    jax_in = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    jax_in[1], jax_in[3] = jax_in[1].T, jax_in[3].T
    want = np.asarray(jax.jit(lambda *a: fused_geglu(*a, block_c=256, block_k=128))(*jax_in))
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_attention_wrapper_takes_cpu_to_plain(qkv):
    q, k, v = (torch.from_numpy(a) for a in qkv)
    before = latent_attention.launches, dict(latent_attention.shapes)
    torch.testing.assert_close(latent_attention(q, k, v), reference_attention(q, k, v), rtol=0, atol=0)
    # no kernel launched on the CPU
    assert (latent_attention.launches, dict(latent_attention.shapes)) == before


def test_geglu_wrapper_takes_cpu_to_plain(ffn):
    args = _port_ffn(ffn)
    before = geglu.launches, dict(geglu.shapes)
    torch.testing.assert_close(geglu(*args), reference_geglu(*args), rtol=0, atol=0)
    assert (geglu.launches, dict(geglu.shapes)) == before


def test_wrappers_never_fall_back_off_the_cpu(qkv, ffn):
    """A tensor that is not on the CPU goes to the kernel or raises; it never
    silently takes the plain version (here: the meta device)."""
    q, k, v = (torch.from_numpy(a) for a in qkv)
    with pytest.raises(ValueError, match="CUDA device"):
        latent_attention(q.to("meta"), k, v)
    args = list(_port_ffn(ffn))
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="CUDA device"):
        geglu(*args)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc: the build raises instead of leaving the kernel missing."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["geglu"])


def test_library_name_tracks_source_content(tmp_path, monkeypatch):
    """The built library's name hashes its source, so an edited kernel is
    rebuilt, never a stale library loaded."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path("k")
    (src / "k.cu").write_text("// two")
    assert _build.library_path("k") != first
    assert _build.sources() == ["k"]
