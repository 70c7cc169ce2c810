"""Kernel plumbing: the implementation choice, the rotation's precision,
the compile cache, and that each Triton kernel lowers for CUDA (checked
here without a GPU)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp



def test_impl_choice_by_backend(monkeypatch):
    from sigmap_tpu.ops import impl

    for layer in impl.LAYERS:
        assert impl.choose(layer) == impl.PLAIN          # CPU default
        assert impl.choose(layer, "triton_interpret") == "triton_interpret"
        with pytest.raises(ValueError):
            impl.choose(layer, "triton")                 # needs a GPU
    with pytest.raises(ValueError):
        impl.choose("nope")
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    for layer in impl.LAYERS:
        assert impl.choose(layer) == impl.TRITON
        assert impl.choose(layer, "plain") == impl.PLAIN
        with pytest.raises(ValueError, match="interpret"):
            impl.choose(layer, "triton_interpret")


def test_rotation_matches_host_f32():
    """Seeds rotated on device (HIGHEST precision) == the host f32
    rotation the window store is built with, to f32 rounding."""
    from sigmap_tpu.mapping.sweep_search import rotate

    rng = np.random.default_rng(5)
    dim = 6
    x = rng.normal(0, 1.5, (4096, dim)).astype(np.float32)
    rot = np.linalg.qr(rng.normal(size=(dim, dim)))[0].astype(np.float32)
    mu = rng.normal(0, 0.1, dim).astype(np.float32)
    host = np.empty_like(x)
    host[:] = -(mu.astype(np.float64) @ rot).astype(np.float32)[None, :]
    for d in range(dim):                   # index/sweep.py's accumulation
        host += x[:, d, None] * rot[d][None, :]
    dev = np.asarray(rotate(jnp.asarray(x), jnp.asarray(mu), jnp.asarray(rot)))
    np.testing.assert_allclose(dev, host, rtol=0, atol=2e-6)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from sigmap_tpu import utils

    old = jax.config.jax_compilation_cache_dir
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert utils.enable_compilation_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old  # JAX reads env
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = utils.enable_compilation_cache()
        assert path == utils.DEFAULT_COMPILE_CACHE
        assert path.endswith(".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def _lowers_for_cuda(fn, *avals):
    """Lower fn for CUDA without a GPU: runs the Pallas->Triton lowering
    of every kernel in it (PTX compilation happens only on the card)."""
    from jax import export

    exp = export.export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[
            export.DisabledSafetyCheck.custom_call("__gpu$xla.gpu.triton")
        ],
    )(*avals)
    text = exp.mlir_module()
    assert "__gpu$xla.gpu.triton" in text
    return text


def _sds(shape, dt):
    return jax.ShapeDtypeStruct(shape, dt)


@pytest.mark.parametrize("K", [8, 5])
def test_sweep_kernel_lowers_for_cuda(K):
    from sigmap_tpu.ops.sweep_kernel import _sweep_triton

    Q, TILE, block, NO = 256, 1024, 32, 27
    _lowers_for_cuda(
        lambda *a: _sweep_triton(*a, radius=0.08, K=K, TILE=TILE, dim=6,
                                 block=block),
        _sds((Q, 8), jnp.float32), _sds((Q // block, 2 * NO + 1), jnp.int32),
        _sds((10, 8, TILE), jnp.float32), _sds((10, TILE), jnp.int32),
    )


def test_chain_kernel_lowers_for_cuda():
    from sigmap_tpu.config import ChainingConfig
    from sigmap_tpu.ops import chain_fused as cf

    R, B, RING, KB = 64, 4, 48, 8
    _lowers_for_cuda(
        lambda *a: cf._dp_triton(*a[:4], a[4:12], a[12], a[13:], KB=KB,
                                 radius=0.08, dim=6, cfg=ChainingConfig()),
        *(_sds((R, B), dt) for dt in (jnp.int32, jnp.int32, jnp.float32,
                                      jnp.int32)),
        *(_sds((RING, B), dt) for dt in cf._RING_DT),
        _sds((B,), jnp.int32),
        *(_sds((B,), dt) for dt in cf._BEST_DT),
    )
