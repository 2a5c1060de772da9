"""Port vs JAX at head dim 128, the width of qwen2.5-14b and
codeqwen1.5-7b: their configs, the plain attention that the card's flash
kernel is held to (against the Pallas kernel in interpret mode), the
prefill ``forward`` with a padding mask, and the batched prefill's page
writer.  Numpy inputs from a seed go to both packages; float32 within
2e-5 unless bit-exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention_pallas import \
    flash_attention as jax_flash_attention
from repro.models.registry import build as jax_build
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import \
    write_prefill_batch_to_pages as jax_write_prefill_batch_to_pages
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models.transformer import (forward,
                                            write_prefill_batch_to_pages)
from repro_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)

NEW_ARCHS = ("qwen2.5-14b", "codeqwen1.5-7b")
TOL = 2e-5


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_configs_equal_the_reference(name):
    assert name in ARCHS
    for got, want in ((get_config(name), jax_get_config(name)),
                      (reduced_config(name), jax_reduced_config(name)),
                      (reduced_config(name, vocab=96),
                       jax_reduced_config(name, vocab=96))):
        assert vars(got) == vars(want)
    assert get_config(name).head_dim == 128
    assert reduced_config(name).head_dim == 64


@pytest.mark.parametrize("b,s,h,kv,window", [
    (2, 37, 10, 2, None),       # qwen2.5-14b's group of 5, ragged S
    (2, 37, 10, 2, 16),         # windowed
    (2, 64, 4, 4, None),        # codeqwen1.5-7b's group of 1
    (1, 21, 4, 4, 8),
])
def test_plain_attention_matches_the_pallas_kernel(b, s, h, kv, window):
    """``ops.attention`` on the CPU (``ref.ref_attention``) and the
    q-chunked ``ref.ref_attention_chunked`` against
    ``flash_attention(..., interpret=True)``."""
    rng = np.random.default_rng(s * 10 + h)
    q, k, v = (rng.normal(size=(b, s, n, 128)).astype(np.float32)
               for n in (h, kv, kv))
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=16, block_k=16, interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.attention(qt, kt, vt, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    chunked = ref.ref_attention_chunked(qt, kt, vt, window=window, chunk=16)
    np.testing.assert_allclose(chunked.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("name", NEW_ARCHS)
def test_forward_with_padding_mask_matches_jax(name):
    """2 layers at head dim 128, right-padded prompts of 12, 5, 9 and 1
    ids in rows of 12 (the engine's layout): the logits at ``plen - 1``
    and the cache rows below ``plen`` against JAX's ``forward(...,
    kv_valid=)``.  Those rows are the same without the mask (bit for
    bit): the card's flash kernel, which masks no keys, computes them so."""
    jcfg = jax_reduced_config(name, vocab=96).replace(d_head=128)
    cfg = reduced_config(name, vocab=96).replace(d_head=128)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(3))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    plens = np.asarray([12, 5, 9, 1])
    rng = np.random.default_rng(0)
    rows = np.zeros((4, 12), np.int32)
    valid = np.zeros((4, 12), bool)
    for i, n in enumerate(plens):
        rows[i, :n] = rng.integers(1, 96, size=n)
        valid[i, :n] = True
    want = jax_forward(jparams, jcfg, jnp.asarray(rows),
                       kv_valid=jnp.asarray(valid), return_cache=True,
                       cache_len=16)
    got = forward(params, cfg, torch.from_numpy(rows),
                  kv_valid=torch.from_numpy(valid), return_cache=True,
                  cache_len=16)
    bare = forward(params, cfg, torch.from_numpy(rows), return_cache=True,
                   cache_len=16)
    assert got.cache["k"].shape == (2, 4, 16, cfg.n_kv_heads, 128)
    for i, n in enumerate(plens):
        np.testing.assert_allclose(got.logits[i, n - 1].numpy(),
                                   np.asarray(want.logits[i, n - 1]),
                                   rtol=0, atol=TOL)
        np.testing.assert_allclose(got.value[i, :n].numpy(),
                                   np.asarray(want.value[i, :n]),
                                   rtol=0, atol=TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                got.cache[key][:, i, :n].numpy(),
                np.asarray(want.cache[key][:, i, :n]), rtol=0, atol=TOL)
            assert torch.equal(bare.cache[key][:, i, :n],
                               got.cache[key][:, i, :n])
        assert torch.equal(bare.logits[i, :n], got.logits[i, :n])
    np.testing.assert_array_equal(got.cache["pos"].numpy(),
                                  np.asarray(want.cache["pos"]))


def test_write_prefill_batch_to_pages_matches_jax_bit_for_bit():
    """Three requests into a pool of [L 2, KV 2, NB 10, BS 4, Dh 128]:
    12 rows over three pages, 5 rows (a partial page; its table's pad
    slots are page 0), and 0 rows (nothing written); rows of P 12 past
    each prompt's length dropped."""
    rng = np.random.default_rng(1)
    shape = (2, 2, 10, 4, 128)
    pools = {k: rng.normal(size=shape).astype(np.float32)
             for k in ("k_pages", "v_pages")}
    cache_k, cache_v = (rng.normal(size=(2, 3, 12, 2, 128)).astype(
        np.float32) for _ in range(2))
    blocks = np.asarray([[3, 7, 1, 0], [9, 4, 0, 0], [5, 0, 0, 0]],
                        np.int32)
    plens = np.asarray([12, 5, 0], np.int32)
    want = jax_write_prefill_batch_to_pages(
        jnp.asarray(cache_k), jnp.asarray(cache_v),
        jax.tree.map(jnp.asarray, pools), jnp.asarray(blocks),
        jnp.asarray(plens))
    got = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    out = write_prefill_batch_to_pages(
        torch.from_numpy(cache_k), torch.from_numpy(cache_v), got, blocks,
        plens)
    assert out is got                                     # in place
    for key in pools:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert not np.array_equal(got["k_pages"].numpy(), pools["k_pages"])
    with pytest.raises(NotImplementedError, match="mesh"):
        write_prefill_batch_to_pages(
            torch.from_numpy(cache_k), torch.from_numpy(cache_v), got,
            blocks, plens, mesh=object())
