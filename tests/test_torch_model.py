"""Port vs JAX: the param bridge and the paged decode steps of the dense
decoder at ``reduced_config("qwen2.5-0.5b")``, on the same (bridged)
weights.  Logits within 1e-4, pools within 1e-5 (float32 on the CPU;
XLA and PyTorch sum matmuls in different orders)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import transformer as jax_tf
from repro.models.registry import build as jax_build
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build
from repro_torch.utils.bridge import from_jax_params, to_numpy

torch.set_num_threads(1)

CFG = reduced_config("qwen2.5-0.5b")
JCFG = jax_reduced_config("qwen2.5-0.5b")
NB, BS, M = 16, 4, 8


@pytest.fixture(scope="module")
def jax_params():
    return jax_build(JCFG).init(jax.random.PRNGKey(0))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def test_configs_match_reference():
    """The copied configs are the reference's, field for field."""
    from repro.configs import get_config as jax_get_config

    assert CFG.__dict__ == JCFG.__dict__
    assert get_config("qwen2.5-0.5b").__dict__ == \
        jax_get_config("qwen2.5-0.5b").__dict__


def test_bridge_roundtrip(jax_params):
    tree = _np_tree(jax_params)
    params = from_jax_params(tree, "cpu")
    back = to_numpy(params)
    flat_a = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # The port's own init has the same names and [L] stacking.
    own = to_numpy(build(CFG).init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(tree)):
        assert a.shape == b.shape


def _pool(seed):
    rng = np.random.default_rng(seed)
    shape = (CFG.n_layers, CFG.n_kv_heads, NB, BS, CFG.head_dim)
    return {"k_pages": rng.standard_normal(shape).astype(np.float32),
            "v_pages": rng.standard_normal(shape).astype(np.float32)}


def _tables(rng, b):
    """M // 2 distinct pages per slot, the rest padded with page 0."""
    tables = np.zeros((b, M), np.int32)
    tables[:, :M // 2] = rng.permutation(NB)[:b * M // 2].reshape(b, -1)
    return tables


def _port_pool(pool):
    return {k: torch.from_numpy(v.copy()) for k, v in pool.items()}


def _assert_pools(got, want):
    for k in ("k_pages", "v_pages"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)


def test_decode_step_paged_matches_jax(jax_params):
    rng = np.random.default_rng(1)
    b = 4
    tables = _tables(rng, b)
    pos = np.asarray([0, 5, 15, 9], np.int32)
    active = np.asarray([True, True, False, True])
    token = rng.integers(0, CFG.vocab_size, b).astype(np.int32)
    pool = _pool(2)
    params = from_jax_params(_np_tree(jax_params), "cpu")

    want, want_pool = jax_tf.decode_step_paged(
        jax_params, JCFG, jnp.asarray(token),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(active), kernel_mode="reference")
    got, got_pool = tf.decode_step_paged(
        params, CFG, torch.from_numpy(token), _port_pool(pool),
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(active))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=1e-4, atol=1e-4)
    _assert_pools(got_pool, want_pool)


@pytest.mark.parametrize("t", [1, 4, 8])
def test_decode_step_paged_varlen_matches_jax(jax_params, t):
    rng = np.random.default_rng(10 + t)
    b = 4
    tables = _tables(rng, b)
    row_len = np.asarray([1, t, 0, max(t - 1, 1)], np.int32)
    row_start = np.asarray([3, 0, 0, 7], np.int32)
    cap = np.asarray([16, 16, 0, 9], np.int32)   # slot 3's tail is capped
    tokens = rng.integers(0, CFG.vocab_size, (b, t)).astype(np.int32)
    pool = _pool(3)
    params = from_jax_params(_np_tree(jax_params), "cpu")

    want, want_pool = jax_tf.decode_step_paged_varlen(
        jax_params, JCFG, jnp.asarray(tokens),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        jnp.asarray(row_start), jnp.asarray(row_len), jnp.asarray(cap),
        kernel_mode="reference")
    got, got_pool = tf.decode_step_paged_varlen(
        params, CFG, torch.from_numpy(tokens), _port_pool(pool),
        torch.from_numpy(tables), torch.from_numpy(row_start),
        torch.from_numpy(row_len), torch.from_numpy(cap))
    live = np.arange(t)[None, :] < row_len[:, None]
    np.testing.assert_allclose(got.logits.numpy()[live],
                               np.asarray(want.logits)[live],
                               rtol=1e-4, atol=1e-4)
    _assert_pools(got_pool, want_pool)


def test_decode_step_paged_multi_matches_jax(jax_params):
    rng = np.random.default_rng(21)
    b, t = 4, 3
    tables = _tables(rng, b)
    pos = np.asarray([2, 0, 6, 11], np.int32)
    active = np.asarray([True, False, True, True])
    cap = np.asarray([16, 16, 8, 16], np.int32)
    tokens = rng.integers(0, CFG.vocab_size, (b, t)).astype(np.int32)
    pool = _pool(4)
    params = from_jax_params(_np_tree(jax_params), "cpu")
    want, want_pool = jax_tf.decode_step_paged_multi(
        jax_params, JCFG, jnp.asarray(tokens),
        {k: jnp.asarray(v) for k, v in pool.items()}, jnp.asarray(tables),
        jnp.asarray(pos), jnp.asarray(active), jnp.asarray(cap),
        kernel_mode="reference")
    got, got_pool = tf.decode_step_paged_multi(
        params, CFG, torch.from_numpy(tokens), _port_pool(pool),
        torch.from_numpy(tables), torch.from_numpy(pos),
        torch.from_numpy(active), torch.from_numpy(cap))
    np.testing.assert_allclose(got.logits.numpy()[active],
                               np.asarray(want.logits)[active],
                               rtol=1e-4, atol=1e-4)
    _assert_pools(got_pool, want_pool)
