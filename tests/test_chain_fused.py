"""chain_fused vs its numpy executable twin (chain_fused_ref).

Randomized anchors + carried chain state, through both DP
implementations: the plain XLA scan and the Triton kernel in interpret
mode.  Gates/scores follow the reference chaining DP
(spatial_index.cc:284-291,495-539) restricted to a ring band; the twin is
the semantic spec.  Integer fields must match exactly; f32 scores within
1e-5 (the twin accumulates coef in float64).
"""

import numpy as np
import pytest

from sigmap_tpu.config import ChainingConfig
from sigmap_tpu.ops.chain_fused import chain_fused, chain_fused_ref

RADIUS = 0.08
DIM = 6


def _random_case(rng, A, B, CARRY, density=0.7, n_groups=4, clustered=True):
    """Anchors roughly emulating seeding output: qpos-major rows, K-slot
    runs sharing qpos, target positions drifting with query."""
    a_t = np.zeros((A, B), np.int32)
    a_q = np.zeros((A, B), np.int32)
    a_d = np.zeros((A, B), np.float32)
    a_g = np.full((A, B), -1, np.int32)
    for b in range(B):
        q = 2
        base_t = rng.integers(100, 5000, n_groups)
        for i in range(A):
            if i % 4 == 0:
                q += int(rng.integers(1, 4))
            if rng.random() > density:
                continue
            g = int(rng.integers(0, n_groups))
            if clustered and rng.random() < 0.7:
                t = base_t[g] + q * 2 + int(rng.integers(-3, 4))
            else:
                t = int(rng.integers(0, 8000))
            a_t[i, b] = t
            a_q[i, b] = q
            a_d[i, b] = rng.random() * RADIUS
            a_g[i, b] = g
    c_score = rng.random((CARRY, B)).astype(np.float32) * 20
    c_stt = rng.integers(0, 4000, (CARRY, B)).astype(np.int32)
    c_stq = rng.integers(0, 50, (CARRY, B)).astype(np.int32)
    c_n = rng.integers(1, 20, (CARRY, B)).astype(np.int32)
    c_sumd = rng.random((CARRY, B)).astype(np.float32)
    # carried anchors sit in rows 0..CARRY-1: ascending q ending below the
    # first fresh anchor's q, with plausible (t, g)
    for b in range(B):
        for i in range(CARRY):
            if rng.random() < 0.5:
                a_g[i, b] = -1
                continue
            a_g[i, b] = int(rng.integers(0, n_groups))
            a_q[i, b] = i // 8
            a_t[i, b] = int(rng.integers(0, 6000))
            a_d[i, b] = rng.random() * RADIUS
    return (a_t, a_q, a_d, a_g, c_score, c_stt, c_stq, c_n, c_sumd)


IMPLS = ["plain", "triton_interpret"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("ring", [16, 64])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kb", [1, 8])
def test_chain_fused_matches_ref(seed, ring, kb, impl):
    rng = np.random.default_rng(seed)
    A, B, CARRY = 96, 5, 16
    args = _random_case(rng, A, B, CARRY)
    cfg = ChainingConfig()
    import jax.numpy as jnp

    sum_f, sum_i, carry = chain_fused(
        *(jnp.asarray(a) for a in args), radius=RADIUS, dim=DIM,
        ring=ring, cfg=cfg, kb=kb, impl=impl,
    )
    rf, ri, rcarry = chain_fused_ref(
        *args, radius=RADIUS, dim=DIM, ring=ring, cfg=cfg, kb=kb
    )
    sum_f = np.asarray(sum_f)
    sum_i = np.asarray(sum_i)
    np.testing.assert_allclose(sum_f[0], rf[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum_f[1], rf[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum_f[2], rf[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum_f[3], rf[3], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(sum_i[:6], ri[:6])
    # carry-out ring state (t q g score stt stq n sumd order differs:
    # kernel returns (t, q, g, score, stt, stq, n, sumd))
    for k, (got, want) in enumerate(zip(carry, rcarry)):
        got = np.asarray(got)
        if got.dtype == np.float32:
            np.testing.assert_allclose(
                got, want, rtol=1e-5, atol=1e-5,
                err_msg=f"carry field {k}",
            )
        else:
            np.testing.assert_array_equal(got, want, err_msg=f"carry field {k}")


@pytest.mark.parametrize("impl", IMPLS)
def test_chain_fused_empty(impl):
    """All-invalid anchors: NEG scores, -1 group, empty carry."""
    import jax.numpy as jnp

    A, B, CARRY = 32, 3, 8
    z_i = jnp.zeros((A, B), jnp.int32)
    z_f = jnp.zeros((A, B), jnp.float32)
    g = jnp.full((A, B), -1, jnp.int32)
    c_f = jnp.zeros((CARRY, B), jnp.float32)
    c_i = jnp.zeros((CARRY, B), jnp.int32)
    sum_f, sum_i, carry = chain_fused(
        z_i, z_i, z_f, g, c_f, c_i, c_i, c_i, c_f,
        radius=RADIUS, dim=DIM, ring=16, impl=impl,
    )
    assert float(np.asarray(sum_f)[0].max()) < -1e29
    assert (np.asarray(sum_i)[0] == -1).all()
    assert (np.asarray(carry[2]) == -2).all()  # group ring stays empty
