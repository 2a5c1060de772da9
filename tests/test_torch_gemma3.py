"""Port vs JAX for gemma3-12b: its configs, the logit softcap, the plain
paged and flash attention at head dim 256 (against the Pallas kernels in
interpret mode), ``forward`` of the reduced config at head dim 64 and
256, and greedy serving through the continuous engine (chunked and
batched prefill) and the static ``generate``, whose 32-token prompts and
16 new tokens pass the reduced config's window of 16 so that the window
masks keys on its local layers.  Numpy inputs from a seed go to both
packages; float32 within 2e-5 unless bit-exact, greedy tokens exact.
Also the launcher on the CPU and the refusal of a flash gradient at head
dim 256.  The kernels at head dim 256 on the card:
``tests/test_torch_cuda_d256.py``."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.kernels.flash_attention_pallas import \
    flash_attention as jax_flash_attention
from repro.kernels.paged_attention_pallas import (
    paged_attention as pallas_paged_attention,
    paged_attention_varlen as pallas_paged_attention_varlen,
)
from repro.models.layers import softcap as jax_softcap
from repro.models.registry import build as jax_build
from repro.models.transformer import forward as jax_forward
from repro.rollout.sampler import generate as jax_generate
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch import kernels
from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.data.tokenizer import get_tokenizer
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import ops
from repro_torch.models import transformer as tf
from repro_torch.models.layers import softcap
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import generate
from repro_torch.serve import ServeEngine
from repro_torch.utils.bridge import from_jax_params

torch.set_num_threads(1)

NAME = "gemma3-12b"
TOL = 2e-5
TOK = get_tokenizer()
PROMPT_LEN, NEW_TOKENS = 32, 16
ENGINE_KW = dict(num_blocks=40, block_size=8, max_batch=4, max_seq_len=64,
                 decode_chunk=4, temperature=0.0, seed=3)


def _configs(d_head):
    jcfg = jax_reduced_config(NAME, vocab=TOK.vocab_size)
    cfg = reduced_config(NAME, vocab=TOK.vocab_size)
    if d_head != 64:
        jcfg, cfg = jcfg.replace(d_head=d_head), cfg.replace(d_head=d_head)
    return jcfg, cfg


@pytest.fixture(scope="module", params=[64, 256], ids=["d64", "d256"])
def model(request):
    """The reduced config at ``d_head``, JAX's init with the dense
    weights scaled x3 (so that greedy tokens vary from step to step
    under the softcap), and the same weights in the port."""
    jcfg, cfg = _configs(request.param)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 3.0 if "'w'" in jax.tree_util.keystr(p) else a,
        jparams)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(3, TOK.vocab_size, size=(n, PROMPT_LEN)).astype(
        np.int32)


def test_configs_equal_the_reference():
    assert NAME in ARCHS
    for got, want in ((get_config(NAME), jax_get_config(NAME)),
                      (reduced_config(NAME), jax_reduced_config(NAME)),
                      (reduced_config(NAME, vocab=96),
                       jax_reduced_config(NAME, vocab=96))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = get_config(NAME)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size) == (
                48, 3840, 16, 8, 256, 15360, 262144)
    assert (full.logit_softcap, full.sliding_window, full.global_every,
            full.tie_embeddings) == (30.0, 1024, 6, True)
    assert [full.window_for_layer(i) for i in range(6)] == [1024] * 5 + [None]
    small = reduced_config(NAME)
    assert (small.sliding_window, small.global_every, small.head_dim) == (
        16, 2, 64)
    assert tf.arch_unsupported(full) is None
    assert tf.paged_arch_unsupported(full) is None


@pytest.mark.parametrize("cap", [30.0, 2.5, None])
def test_softcap_matches_jax(cap):
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((3, 5, 97)) * 40).astype(np.float32)
    got = softcap(torch.from_numpy(logits), cap).numpy()
    want = np.asarray(jax_softcap(jnp.asarray(logits), cap))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    if cap is None:
        np.testing.assert_array_equal(got, logits)
    else:
        assert np.abs(got).max() <= cap


def test_arch_unsupported_names_the_one_feature_it_refuses():
    base = get_config(NAME)
    assert "gelu" in tf.arch_unsupported(base.replace(activation="gelu"))
    assert "encoder" in tf.arch_unsupported(base.replace(encoder_layers=2))
    assert "vision" in tf.arch_unsupported(
        base.replace(vision_prefix_len=8))
    moe = jax_get_config("llama4-scout-17b-a16e").moe
    assert "experts" in tf.arch_unsupported(base.replace(moe=moe))


def _paged_inputs(rng, b, h, kv, bs, lens, t=None):
    """Pools of distinct shuffled pages for contexts ``lens``, a query
    ``[B, H, 256]`` (or ``[B, T, H, 256]``) and the block tables."""
    d = 256
    m = max(-(-n // bs) for n in lens)
    nb = b * m + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, m), np.int32)
    for i, n in enumerate(lens):
        pages = -(-n // bs)
        tables[i, :pages] = perm[i * m:i * m + pages]
    kp, vp = (rng.standard_normal((kv, nb, bs, d)).astype(np.float32)
              for _ in range(2))
    shape = (b, h, d) if t is None else (b, t, h, d)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, kp, vp, tables


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("window", [None, 16])
def test_plain_paged_decode_at_head_dim_256_matches_pallas(window):
    """``ops.paged_attention`` on the CPU at gemma3's group of 2 and head
    dim 256 against ``paged_attention(..., interpret=True)``; contexts
    past the window, an idle slot exactly zero."""
    rng = np.random.default_rng(5)
    lens = np.asarray([45, 17, 40, 0], np.int32)
    q, kp, vp, tables = _paged_inputs(rng, 4, 4, 2, 8, [45, 17, 40, 1])
    got = ops.paged_attention(*_t(q, kp, vp, tables, lens),
                              window=window).numpy()
    want = pallas_paged_attention(*_j(q, kp, vp, tables, lens),
                                  window=window, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_array_equal(got[-1], 0.0)


@pytest.mark.parametrize("window", [None, 16])
def test_plain_paged_varlen_at_head_dim_256_matches_pallas(window):
    """``ops.paged_attention_varlen`` on the CPU at head dim 256: a
    prefill tile of 16 rows past the window's reach, a decode row, a
    ragged tile and an idle slot, against the Pallas kernel in
    interpret mode; padding rows exactly zero."""
    rng = np.random.default_rng(6)
    row_start = np.asarray([24, 40, 3, 0], np.int32)
    row_len = np.asarray([16, 1, 9, 0], np.int32)
    lens = [int(a + n) or 1 for a, n in zip(row_start, row_len)]
    q, kp, vp, tables = _paged_inputs(rng, 4, 4, 2, 8, lens, t=16)
    args = (q, kp, vp, tables, row_start, row_len)
    got = ops.paged_attention_varlen(*_t(*args), window=window).numpy()
    want = pallas_paged_attention_varlen(*_j(*args), window=window,
                                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)
    for i in range(4):
        np.testing.assert_array_equal(got[i, row_len[i]:], 0.0)


@pytest.mark.parametrize("b,s,h,kv,window", [
    (2, 40, 4, 2, None), (2, 40, 4, 2, 16), (1, 33, 2, 2, 8)])
def test_plain_flash_at_head_dim_256_matches_pallas(b, s, h, kv, window):
    """``ops.attention`` on the CPU (``ref.ref_attention``) at head dim
    256 against ``flash_attention(..., interpret=True)``."""
    rng = np.random.default_rng(s + h)
    q, k, v = (rng.normal(size=(b, s, n, 256)).astype(np.float32)
               for n in (h, kv, kv))
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        block_q=16, block_k=16, interpret=True))
    got = ops.attention(*_t(q, k, v), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("d_head", [64, 256])
def test_forward_matches_jax(d_head):
    """Logits and values of every position of four 32-token rows from
    JAX's init: the local layer's window of 16 masks keys, and the
    logits go through the softcap."""
    jcfg, cfg = _configs(d_head)
    jparams = jax_build(jcfg).init(jax.random.PRNGKey(1))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = _prompts(4, seed=2)
    want = jax_forward(jparams, jcfg, jnp.asarray(tokens))
    got = tf.forward(params, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(got.value.numpy(), np.asarray(want.value),
                               rtol=0, atol=TOL)
    uncapped = tf.forward(params, cfg.replace(logit_softcap=None),
                          torch.from_numpy(tokens)).logits
    np.testing.assert_allclose(got.logits.numpy(),
                               softcap(uncapped, 30.0).numpy(), rtol=0,
                               atol=1e-6)
    assert not torch.equal(got.logits, uncapped)


def _serve(eng, prompts):
    for i, p in enumerate(prompts):
        eng.submit(p, NEW_TOKENS, request_id=i)
    return {t.request_id: t for t in eng.run(max_steps=500)}


@pytest.mark.parametrize("mode", ["chunked", "batched"])
def test_continuous_engine_greedy_matches_jax(model, mode):
    """Four 32-token prompts, 16 new tokens each, greedy, through the
    chunked-prefill engine (varlen rounds) and the batched prefill
    (``forward`` then the page writer): the same tokens, counts and
    pools as JAX's engine."""
    jcfg, cfg, jparams, params = model
    kw = dict(ENGINE_KW, chunked_prefill=mode == "chunked")
    prompts = list(_prompts(4, seed=4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jeng = JaxServeEngine(jax_build(jcfg), jparams, **kw)
        eng = ServeEngine(build(cfg), params, device="cpu", **kw)
    want, got = _serve(jeng, prompts), _serve(eng, prompts)
    assert sorted(got) == sorted(want) == [0, 1, 2, 3]
    for rid in want:
        np.testing.assert_array_equal(got[rid].tokens, want[rid].tokens)
        assert got[rid].num_tokens == NEW_TOKENS
    for key in ("steps", "decode_steps", "prefills", "prefill_dispatches",
                "prefill_tokens", "tokens_out"):
        assert getattr(eng.stats, key) == getattr(jeng.stats, key), key
    for key in ("k_pages", "v_pages"):
        g, w = eng.pages[key].numpy(), np.asarray(jeng.pages[key])
        assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max()), key
    assert eng.pages["k_pages"].shape[-1] == cfg.head_dim
    assert len({int(t) for r in got.values() for t in r.tokens}) > 5


def test_static_generate_greedy_matches_jax(model):
    """``generate`` (a dense prefill, then one-token decode steps over
    the dense cache with each layer's window): greedy tokens exact,
    ``log_beta`` and values within 1e-5 of their largest magnitude."""
    jcfg, cfg, jparams, params = model
    prompts = _prompts(4, seed=7)
    want = jax_generate(jax_build(jcfg), jparams, jnp.asarray(prompts),
                        jax.random.PRNGKey(0), max_new_tokens=NEW_TOKENS,
                        temperature=0.0)
    got = generate(build(cfg), params, torch.from_numpy(prompts),
                   max_new_tokens=NEW_TOKENS, temperature=0.0)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    w = np.asarray(want.values)
    assert np.abs(got.values.numpy() - w).max() <= 1e-5 * max(
        1.0, np.abs(w).max())
    assert len(np.unique(got.completion.numpy())) > 5


@pytest.mark.parametrize("flags", [
    ["--engine", "continuous"],
    ["--engine", "continuous", "--no-chunked-prefill"],
    ["--engine", "static"]])
def test_launcher_serves_gemma3_on_the_cpu(capsys, flags):
    from repro_torch.launch import serve

    argv = ["--arch", NAME, "--device", "cpu", "--batch", "2",
            "--max-new-tokens", "4", "--temperature", "0"] + flags
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert serve.main(argv) in (0, None)
    out = capsys.readouterr().out
    head = "continuous decode:" if "continuous" in flags else "decode:"
    assert any(ln.startswith(head) for ln in out.splitlines()), out


def test_flash_gradient_at_head_dim_256_raises_before_any_launch():
    """The backward has no head-dim-256 path: the check the card's
    route runs first (in ``FlashAttentionFn.forward`` and the backward's
    wrapper) raises ``ValueError``, so nothing launches; the forward's
    instantiation at 256 is ``d256`` in float32 and ``wgmma256`` in
    bfloat16."""
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="head dim 256"):
        flash_mod._check_bwd_head_dim(256)
    flash_mod._check_bwd_head_dim(64)
    x = torch.zeros(1, 4, 2, 256)
    lse = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="head dim 256"):
        flash_mod.flash_attention_bwd_cuda(x, x, x, x, lse, x)
    assert sum(kernels.launch_counts().values()) == 0
    for dtype, impl in ((torch.float32, "d256"),
                        (torch.bfloat16, "wgmma256")):
        assert flash_mod.flash_impl(dtype, 256) == impl
        assert flash_mod.flash_impl(dtype, 256, lse=True) == impl
        assert impl in flash_mod.FLASH_SYMBOLS
    # The CPU route differentiates the plain attention at 256.
    q = torch.randn(1, 5, 2, 256, requires_grad=True)
    ops.attention(q, q.detach(), q.detach()).sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
