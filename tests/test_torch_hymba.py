"""Port vs JAX: the hymba static serve path at ``reduced_config("hymba-1.5b")``
(2 layers, d 256, 5 query heads over 1 kv head of 64, window 16 with every
second layer global, an SSM of state 16, conv 4, inner 512, the math
tokenizer's vocab) on the same weights, and the plain versions of the
two kernels it runs: flash attention and the selective scan.

Weights cross over through ``utils.bridge.from_jax_params``; inputs and
Gumbel noise are made with numpy or replayed from the JAX key chain, so
sampling is token-exact.  Prompts of 32 tokens make the window bite in
layer 0.  The CUDA kernels are held to the same plain versions on the
card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances and why:
* ``ref_attention`` against the Pallas kernel in interpret mode 2e-5
  (bfloat16 3e-2), the JAX kernel test's: an online softmax over 32-key
  blocks sums in another order; against JAX's ``ref_attention`` 1e-5;
* ``ref_ssm_scan`` against JAX's scan 2e-4, the JAX kernel test's (the
  Pallas body does not run on the installed JAX: ``pl.load``/``pl.store``
  are gone);
* blocks, the cache and generation (log_beta, values) 1e-5; model
  logits and values 1e-4 (float32 matmuls in another order through two
  layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data.mathgen import MathTaskDataset
from repro.data.tokenizer import get_tokenizer
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention_pallas import flash_attention
from repro.models import attention as jax_attn
from repro.models import ssm as jax_ssm
from repro.models.registry import build as jax_build
from repro.rollout.sampler import generate as jax_generate
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import generate
from repro_torch.utils.bridge import from_jax_params
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("hymba-1.5b", vocab=TOK.vocab_size)
CFG = reduced_config("hymba-1.5b", vocab=TOK.vocab_size)
PROMPT_LEN = 32


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def weights():
    params = jax_build(JCFG).init(jax.random.PRNGKey(0))
    return params, from_jax_params(_np_tree(params), "cpu")


@pytest.fixture(scope="module")
def scaled_weights(weights):
    """Dense weights scaled x3, so random-init generation varies from
    token to token."""
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a * 3.0 if "'w'" in jax.tree_util.keystr(p) else a,
        weights[0])
    return params, from_jax_params(_np_tree(params), "cpu")


def _close(got, want, tol):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _both(args):
    to_jax = lambda a: None if a is None else jnp.asarray(a)
    to_torch = lambda a: None if a is None else torch.from_numpy(a)
    return [to_jax(a) for a in args], [to_torch(a) for a in args]


# ---------------------------------------------------------------------------
# Flash attention's plain version
# ---------------------------------------------------------------------------


FLASH_SWEEP = [(64, 4, 2, 32, None), (100, 4, 1, 16, None),
               (128, 8, 8, 64, 32), (96, 4, 2, 32, 16), (65, 2, 2, 8, 7)]


def _qkv(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("s,h,kv,d,window", FLASH_SWEEP)
def test_ref_attention_matches_the_pallas_kernel(s, h, kv, d, window):
    jargs, targs = _both(_qkv(2, s, h, kv, d, seed=s + h + d))
    want = flash_attention(*jargs, window=window, block_q=32, block_k=32,
                           interpret=True)
    _close(ref.ref_attention(*targs, window=window), want, 2e-5)
    _close(ops.attention(*targs, window=window), want, 2e-5)


def test_ref_attention_matches_the_pallas_kernel_in_bfloat16():
    jargs, targs = _both(_qkv(1, 64, 4, 2, 32, seed=1))
    jargs = [a.astype(jnp.bfloat16) for a in jargs]
    targs = [t.bfloat16() for t in targs]
    want = flash_attention(*jargs, block_q=32, block_k=32, interpret=True)
    got = ref.ref_attention(*targs)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None), (False, 5)])
def test_ref_attention_matches_jax_ref_attention(causal, window):
    jargs, targs = _both(_qkv(3, 23, 6, 3, 16, seed=4))
    want = jax_ref.ref_attention(*jargs, causal=causal, window=window)
    _close(ref.ref_attention(*targs, causal=causal, window=window), want,
           1e-5)
    _close(ops.attention(*targs, causal=causal, window=window), want, 1e-5)


# ---------------------------------------------------------------------------
# The selective scan's plain version
# ---------------------------------------------------------------------------


def _ssm_inputs(b, s, i, n, seed, state=True):
    """The JAX sweep's draws: u, b, c ~ N(0, 1), dt = softplus(N(0, 1)),
    a = -exp(N(0, 1)), h0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    g = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt = np.log1p(np.exp(g(b, s, i))).astype(np.float32)
    return [g(b, s, i), dt, g(b, s, n), g(b, s, n),
            (-np.exp(g(i, n))).astype(np.float32),
            g(b, i, n) if state else None]


@pytest.mark.parametrize("s,i,n", [(16, 32, 8), (33, 100, 16),
                                   (64, 128, 16), (7, 8, 4), (1, 40, 16)])
@pytest.mark.parametrize("state", [True, False])
def test_ref_ssm_scan_and_the_cpu_route_match_jax(s, i, n, state):
    jargs, targs = _both(_ssm_inputs(2, s, i, n, seed=s * i, state=state))
    y_j, h_j = jax_ref.ref_ssm_scan(*jargs)
    for y, h in (ref.ref_ssm_scan(*targs), ops.ssm_scan(*targs)):
        assert bool(torch.isfinite(y).all())
        _close(y, y_j, 2e-4)
        _close(h, h_j, 2e-4)
    y_s, h_s = jax_ssm._ssm_scan(*jargs)
    _close(ref.ref_ssm_scan(*targs)[0], y_s, 2e-4)


def test_ref_ssm_scan_keeps_bfloat16_outputs_and_a_float32_state():
    _, targs = _both(_ssm_inputs(1, 5, 16, 16, seed=3))
    bf = [t.bfloat16() for t in targs[:4]] + targs[4:]
    y, h = ref.ref_ssm_scan(*bf)
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    want, _ = ref.ref_ssm_scan(*[t.float() for t in bf[:4]], *bf[4:])
    assert (y.float() - want).abs().max().item() <= 2e-2 * max(
        1.0, want.abs().max().item())


def _strided_bc(b_t, c_t, lead=5):
    """``b_t`` and ``c_t`` as column slices of one ``[B, S, lead + 2N]``
    tensor, the layout of the model's ``x_proj`` output."""
    n = b_t.shape[-1]
    proj = torch.randn(*b_t.shape[:2], lead + 2 * n,
                       generator=torch.Generator().manual_seed(0))
    proj[..., lead:lead + n] = b_t
    proj[..., lead + n:] = c_t
    return proj[..., lead:lead + n], proj[..., lead + n:]


@pytest.mark.parametrize("s,i,n", [(33, 100, 16), (1, 40, 16), (7, 8, 4)])
def test_ops_ssm_scan_reads_strided_b_and_c_like_contiguous_ones(s, i, n):
    """``b_t`` / ``c_t`` as slices of one wider tensor give what the
    contiguous ones give, exactly, and JAX's scan within 2e-4."""
    jargs, targs = _both(_ssm_inputs(3, s, i, n, seed=s + i))
    sb, sc = _strided_bc(targs[2], targs[3])
    assert not sb.is_contiguous() and sb.stride(1) == 5 + 2 * n
    y, h = ops.ssm_scan(targs[0], targs[1], sb, sc, *targs[4:])
    y_c, h_c = ops.ssm_scan(*targs)
    assert torch.equal(y, y_c) and torch.equal(h, h_c)
    y_j, h_j = jax_ssm._ssm_scan(*jargs)
    _close(y, y_j, 2e-4)
    _close(h, h_j, 2e-4)


@pytest.mark.parametrize("s,chunk,dt_scale", [
    (50, 1, 1.0), (50, 7, 1.0), (50, 64, 1.0), (130, 64, 1.0),
    (64, 64, 1.0), (65, 64, 1.0), (29, 7, 1.0), (40, 7, 200.0)])
@pytest.mark.parametrize("state", [True, False])
def test_chunked_scan_algebra_matches_jax(s, chunk, dt_scale, state):
    """The chunked form of the card's long-sequence instantiation (chunk
    end states from zero, the carry across chunks, each chunk re-run
    from its true start) against JAX's step-by-step scan, at chunk sizes
    1, 7 and 64, ragged last chunks, a carried state, and dt x 200, where
    exp(dt * a) and exp(a * sum(dt)) underflow to 0: within 2e-4."""
    args = _ssm_inputs(2, s, 24, 16, seed=s * chunk, state=state)
    args[1] = args[1] * np.float32(dt_scale)
    jargs, targs = _both(args)
    y, h = ref.ref_ssm_scan_chunked(*targs, chunk=chunk)
    y_j, h_j = jax_ssm._ssm_scan(*jargs)
    _close(y, y_j, 2e-4)
    _close(h, h_j, 2e-4)


def test_ssm_forward_hands_the_scan_b_and_c_as_views_of_x_proj(weights,
                                                                monkeypatch):
    """The block passes ``b_t`` and ``c_t`` to the scan as they come out
    of ``x_proj``: slices of one tensor, not copies (the card reads them
    in place), with the output and state of contiguous copies."""
    _, tp = _layer(weights, "ssm", 0)
    seen = []
    real = ssm.kops.ssm_scan

    def spy(u, dt, b_t, c_t, a, h0=None):
        seen.append((b_t, c_t))
        return real(u, dt, b_t, c_t, a, h0)

    monkeypatch.setattr(ssm.kops, "ssm_scan", spy)
    x = torch.randn(2, 5, CFG.d_model,
                    generator=torch.Generator().manual_seed(3))
    out, (h, _) = ssm.ssm_forward(tp, x, CFG.ssm)
    monkeypatch.setattr(
        ssm.kops, "ssm_scan", lambda u, dt, b_t, c_t, a, h0=None: real(
            u, dt, b_t.contiguous(), c_t.contiguous(), a, h0))
    out_c, (h_c, _) = ssm.ssm_forward(tp, x, CFG.ssm)
    assert torch.equal(out, out_c) and torch.equal(h, h_c)
    (b_t, c_t), = seen
    n = CFG.ssm.state_dim
    assert b_t.untyped_storage().data_ptr() == \
        c_t.untyped_storage().data_ptr()
    assert c_t.data_ptr() - b_t.data_ptr() == n * b_t.element_size()
    assert not b_t.is_contiguous() and b_t.stride(-1) == 1


@pytest.mark.parametrize("b,s,i,impl,chunk", [
    (8, 1, 3200, "serial", 0), (8, 32, 3200, "serial", 0),
    (1, 100, 3200, "serial", 0), (1, 128, 3200, "chunked", 32),
    (2, 128, 3200, "serial", 0), (1, 512, 3200, "chunked", 32),
    (4, 512, 3200, "chunked", 64), (6, 2048, 3200, "chunked", 64),
    (8, 512, 3200, "serial", 0), (1, 2048, 3200, "chunked", 64),
    (2, 130, 300, "chunked", 32)])
def test_ssm_instantiation_follows_length_and_grid(b, s, i, impl, chunk):
    """Decode steps and hymba's S 32 prefill take the serial kernel; the
    chunked scan takes over from S 128 while the serial grid (a block per
    128 channels of a row) fills at most a quarter of the 132 SMs, and
    from S 512 while it is under 1.5 times their number (B 8 at I 3200
    is not); in 64-step chunks where that still gives about three blocks
    an SM, else 32."""
    from repro_torch.kernels.ssm_scan import chunk_steps, ssm_impl

    assert ssm_impl(b, s, i) == impl
    if chunk:
        assert chunk_steps(b, s, i) == chunk


def test_ssm_row_stride_accepts_slices_and_refuses_other_layouts():
    from repro_torch.kernels.ssm_scan import bc_row_stride

    proj = torch.zeros(3, 5, 132)
    assert bc_row_stride(proj[..., 100:116]) == 132
    assert bc_row_stride(proj[..., 116:]) == 132
    assert bc_row_stride(torch.zeros(3, 5, 16)) == 16
    assert bc_row_stride(torch.zeros(3, 1, 132)[..., 100:116]) == 132
    assert bc_row_stride(torch.zeros(5, 3, 16).transpose(0, 1)) is None
    assert bc_row_stride(proj[:, ::2, 100:116]) is None       # rows uneven
    assert bc_row_stride(proj[..., 100:116:2]) is None        # columns
    assert bc_row_stride(torch.zeros(5, 16)) is None


# ---------------------------------------------------------------------------
# Blocks, model, generation
# ---------------------------------------------------------------------------


def _layer(weights, name, i=0):
    jp, tp = weights
    return (jax.tree.map(lambda a: a[i], jp["layers"][name]),
            {k: (v[i] if not isinstance(v, dict) else
                 {kk: vv[i] for kk, vv in v.items()})
             for k, v in tp["layers"][name].items()})


@pytest.mark.parametrize("carried", [False, True])
def test_ssm_forward_matches_jax(weights, carried):
    jp, tp = _layer(weights, "ssm", 1)
    inner, n = 2 * CFG.d_model, CFG.ssm.state_dim
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 6, CFG.d_model)).astype(np.float32)
    h0 = rng.standard_normal((3, inner, n)).astype(np.float32)
    conv = rng.standard_normal((3, CFG.ssm.conv_width - 1, inner)).astype(
        np.float32)
    jstate = (jnp.asarray(h0), jnp.asarray(conv)) if carried else None
    tstate = ((torch.from_numpy(h0), torch.from_numpy(conv)) if carried
              else None)
    out_j, (h_j, conv_j) = jax_ssm.ssm_forward(jp, jnp.asarray(x), JCFG.ssm,
                                               jstate)
    out, (h_t, conv_t) = ssm.ssm_forward(tp, torch.from_numpy(x), CFG.ssm,
                                         tstate)
    _close(out, out_j, 1e-5)
    _close(h_t, h_j, 1e-5)
    _close(conv_t, conv_j, 1e-5)


def test_attn_forward_with_a_gradient_matches_jax_autograd(weights,
                                                           monkeypatch):
    """With grad the einsum runs (values and gradients match JAX's
    autodiff); without it ``kops.attention`` runs, with the same
    values."""
    jp, tp = _layer(weights, "attn", 0)
    rng = np.random.default_rng(5)
    b, s = 2, 24
    x = rng.standard_normal((b, s, CFG.d_model)).astype(np.float32)
    w = rng.standard_normal((b, s, CFG.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    kw = dict(n_heads=CFG.n_heads, n_kv_heads=CFG.n_kv_heads,
              rope_theta=CFG.rope_theta)
    window = CFG.window_for_layer(0)
    assert window == 16 < s

    def jloss(p):
        out, _ = jax_attn.attn_forward(p, jnp.asarray(x), jnp.asarray(pos),
                                       head_dim=CFG.head_dim,
                                       window=float(window), **kw)
        return jnp.sum(out * jnp.asarray(w)), out

    (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jp)
    calls = []
    real = ops.attention
    monkeypatch.setattr(attn.kops, "attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tparams = jax.tree.map(lambda t: t.clone().requires_grad_(True), tp)
    out, _ = attn.attn_forward(tparams, torch.from_numpy(x),
                               torch.from_numpy(pos.copy()), window=window,
                               **kw)
    assert calls == []
    loss = torch.sum(out * torch.from_numpy(w))
    loss.backward()
    _close(out, jout, 1e-5)
    for name in ("wq", "wk", "wv", "wo"):
        _close(tparams[name]["w"].grad, jgrad[name]["w"], 1e-4)
    with torch.no_grad():
        out_ng, _ = attn.attn_forward(tp, torch.from_numpy(x),
                                      torch.from_numpy(pos.copy()),
                                      window=window, **kw)
    assert calls == [1]
    _close(out_ng, jout, 1e-5)


def _prompts(n=8, seed=1):
    """Left-padded math prompts, as the static serve path feeds them."""
    ds = MathTaskDataset(prompt_len=PROMPT_LEN, level=0, seed=seed)
    return ds.sample_batch(n)[0]


def test_forward_and_decode_steps_match_jax(weights):
    jparams, params = weights
    tokens = _prompts(4)
    jb, tb = jax_build(JCFG), build(CFG)
    want = jb.forward(jparams, jnp.asarray(tokens), return_cache=True,
                      cache_len=PROMPT_LEN + 4)
    got = tb.forward(params, torch.from_numpy(tokens), return_cache=True,
                     cache_len=PROMPT_LEN + 4)
    _close(got.logits, want.logits, 1e-4)
    _close(got.value, want.value, 1e-4)
    assert sorted(got.cache) == sorted(want.cache) == [
        "conv", "k", "pos", "ssm", "v"]
    for k in got.cache:
        _close(got.cache[k], want.cache[k], 1e-5)
    jcache, cache = want.cache, got.cache
    rng = np.random.default_rng(2)
    for _ in range(3):
        token = rng.integers(3, TOK.vocab_size, 4).astype(np.int32)
        jout, jcache = jb.decode_step(jparams, jnp.asarray(token), jcache)
        out, cache = tb.decode_step(params, torch.from_numpy(token), cache)
        _close(out.logits, jout.logits, 1e-4)
        _close(out.value, jout.value, 1e-4)
        for k in cache:
            _close(cache[k], jcache[k], 1e-5)


def _jax_noise(key, n):
    """The port's noise hook replaying ``jax.random.categorical``'s draws
    under ``generate``'s per-step key split."""
    keys = jax.random.split(key, n)
    return lambda t, shape: torch.from_numpy(
        np.array(jax.random.gumbel(keys[t], shape)))


@pytest.mark.parametrize("temperature,top_p", [(0.0, 1.0), (1.0, 1.0),
                                               (0.7, 0.9)])
def test_generate_matches_jax_token_exact(scaled_weights, temperature,
                                          top_p):
    jparams, params = scaled_weights
    prompts = _prompts(8, seed=3)
    key = jax.random.PRNGKey(5)
    want = jax_generate(jax_build(JCFG), jparams, jnp.asarray(prompts), key,
                        max_new_tokens=10, temperature=temperature,
                        top_p=top_p)
    got = generate(build(CFG), params, torch.from_numpy(prompts),
                   max_new_tokens=10, temperature=temperature, top_p=top_p,
                   noise=_jax_noise(key, 10))
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    for g, w in ((got.log_beta, want.log_beta), (got.values, want.values)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * max(1.0,
                                                         np.abs(w).max())
    assert len(np.unique(got.completion.numpy())) > 5
    if temperature > 0:
        assert got.log_beta.min() < -0.5           # draws off the argmax


# ---------------------------------------------------------------------------
# Config, param tree, launchers, refusals
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    assert dataclasses.asdict(CFG) == dataclasses.asdict(JCFG)
    assert dataclasses.asdict(get_config("hymba-1.5b")) == \
        dataclasses.asdict(jax_get_config("hymba-1.5b"))
    assert (CFG.sliding_window, CFG.global_every) == (16, 2)
    assert [CFG.window_for_layer(i) for i in range(2)] == [16, None]


def _spec(tree):
    """``{path: (shape, dtype name)}`` of a nested dict of arrays."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)] = (tuple(leaf.shape),
                                           np.dtype(leaf.dtype).name)
    return out


def _torch_spec(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}['{k}']"
        if isinstance(v, dict):
            out.update(_torch_spec(v, key))
        else:
            out[key] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


def test_param_tree_matches_jax_reduced(weights):
    params = build(CFG).init(torch.Generator().manual_seed(0))
    assert _torch_spec(params) == _spec(weights[0])
    lp = params["layers"]["ssm"]
    assert "lm_head" in params and lp["a_log"].shape == (2, 512, 16)
    assert torch.equal(lp["a_log"][1, 7],
                       torch.log(torch.arange(1, 17, dtype=torch.float32)))
    _close(lp["a_log"], weights[0]["layers"]["ssm"]["a_log"], 1e-7)
    assert torch.equal(lp["d_skip"], torch.ones(2, 512))


def test_param_tree_matches_jax_full_width(monkeypatch):
    """Full hymba-1.5b, nothing allocated: JAX by ``eval_shape``, the port
    under a fake-tensor mode (its truncated normal resamples by value, so
    it is stubbed by an empty tensor of the same shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    jcfg = jax_get_config("hymba-1.5b")
    want = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    monkeypatch.setattr(layers, "_trunc_normal",
                        lambda gen, shape: torch.empty(tuple(shape)))
    with FakeTensorMode():
        got = build(get_config("hymba-1.5b")).init(torch.Generator())
    assert _torch_spec(got) == _spec(want)
    n = sum(x.numel() for x in tree_leaves(got))
    assert 1.66e9 < n < 1.67e9


def test_paged_functions_refuse_hymba_with_the_reference_message():
    from repro.models.transformer import paged_arch_unsupported

    bundle = build(CFG)
    assert bundle.decode_step_paged is None
    assert bundle.init_paged_cache is None
    assert tf.arch_unsupported(CFG) is None
    assert tf.paged_arch_unsupported(CFG) == paged_arch_unsupported(JCFG)
    with pytest.raises(ValueError, match="unpaged ssm/conv state"):
        tf.init_paged_cache(CFG, 8, 4)


def test_static_serve_launcher_runs_hymba_on_the_cpu(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--engine", "static", "--arch", "hymba-1.5b",
                       "--device", "cpu", "--batch", "3",
                       "--max-new-tokens", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("decode: 12 tokens in ")
    assert out[0].endswith("tok/s on this host's CPU)")
    assert len(out) == 4 and all("(gold " in line for line in out[1:])


def test_continuous_engine_refuses_hymba_with_the_reference_message():
    from repro.models.transformer import paged_arch_unsupported
    from repro_torch.launch import serve

    with pytest.raises(ValueError) as err:
        serve.main(["--engine", "continuous", "--arch", "hymba-1.5b",
                    "--device", "cpu", "--requests", "1"])
    assert paged_arch_unsupported(JCFG) in str(err.value)


def test_train_launcher_refuses_hymba():
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="backward of the ssm_scan kernel"):
        train.main(["rlvr", "--arch", "hymba-1.5b", "--device", "cpu"])
