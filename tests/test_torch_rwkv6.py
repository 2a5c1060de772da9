"""Port vs JAX: the rwkv6 serve path at ``reduced_config("rwkv6-1.6b")``
(2 layers, d 128, two 64-wide WKV heads, the math tokenizer's vocab) on
the same weights, and the WKV6 recurrence's plain version.

Weights cross over through ``utils.bridge.from_jax_params``; inputs and
Gumbel noise are made with numpy or replayed from the JAX key chain, so
sampling is token-exact.  The CUDA kernel is held to the same plain
version on the card (``test_torch_cuda.py``, ``chip_smoke.py``).

Tolerances and why:
* ``ref_wkv6`` and ``ref_wkv6_chunked`` against the Pallas kernel in
  interpret mode 3e-4, the JAX kernel test's: the chunked form sums in
  another order and through exp/log of the decays;
* ``ref_wkv6_chunked`` against JAX's step-by-step ``ref_wkv6`` 1e-5: it
  takes the decays as products over spans of steps, never their logs;
* against JAX's step-by-step ``ref_wkv6`` 1e-5: the same float32
  recurrence, einsum sums in another order;
* blocks, generation (log_beta, values) and the cache 1e-5; model logits
  and values 1e-4 (float32 matmuls in another order through two layers).
"""
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
from repro.kernels.wkv6_pallas import wkv6_pallas
from repro.models import rwkv6 as jax_rwkv
from repro.models.registry import build as jax_build
from repro.rollout.sampler import generate as jax_generate
from repro_torch.configs import get_config, reduced_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers
from repro_torch.models import rwkv6 as rwkv
from repro_torch.models import transformer as tf
from repro_torch.models.registry import build
from repro_torch.rollout.sampler import generate
from repro_torch.utils.bridge import from_jax_params
from repro_torch.utils.tree import tree_leaves

torch.set_num_threads(1)

TOK = get_tokenizer()
JCFG = jax_reduced_config("rwkv6-1.6b", vocab=TOK.vocab_size)
CFG = reduced_config("rwkv6-1.6b", vocab=TOK.vocab_size)
PROMPT_LEN = 16


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


# ---------------------------------------------------------------------------
# The recurrence's plain version
# ---------------------------------------------------------------------------


def _wkv_inputs(b, s, h, kd, vd, seed, state=True, decay=None):
    """r, k, v ~ N(0, 1), decays in (0.1, 0.9) (or all ``decay``),
    u ~ 0.3 N(0, 1), state ~ N(0, 1): the JAX kernel sweep's draws."""
    rng = np.random.default_rng(seed)
    n = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    w = (0.8 / (1 + np.exp(-n(b, s, h, kd))) + 0.1).astype(np.float32)
    if decay is not None:
        w = np.full((b, s, h, kd), decay, np.float32)
    args = [n(b, s, h, kd), n(b, s, h, kd), n(b, s, h, vd), w,
            0.3 * n(h, kd)]
    return args + [n(b, h, kd, vd) if state else None]


def _both(args):
    to_jax = lambda a: None if a is None else jnp.asarray(a)
    to_torch = lambda a: None if a is None else torch.from_numpy(a)
    return [to_jax(a) for a in args], [to_torch(a) for a in args]


@pytest.mark.parametrize("s,h,kd,vd,chunk", [
    (32, 2, 16, 16, 8), (50, 3, 32, 32, 16), (64, 2, 64, 64, 64),
    (17, 1, 8, 8, 4)])
def test_ref_wkv6_matches_the_pallas_kernel(s, h, kd, vd, chunk):
    jargs, targs = _both(_wkv_inputs(2, s, h, kd, vd, seed=s * h + kd))
    y_p, sf_p = wkv6_pallas(*jargs, chunk=chunk, interpret=True)
    y, sf = ref.ref_wkv6(*targs)
    _close(y, y_p, 3e-4)
    _close(sf, sf_p, 3e-4)


@pytest.mark.parametrize("case", ["state", "no_state", "one_step",
                                  "extreme_decay", "serve_heads"])
def test_ref_wkv6_and_the_cpu_route_match_jax(case):
    b, s, h, kd, state, decay = 2, 23, 3, 64, True, None
    if case == "no_state":
        state = False
    elif case == "one_step":
        s = 1
    elif case == "extreme_decay":   # near-total forgetting stays finite
        s, h, state, decay = 32, 1, False, 1e-6
    elif case == "serve_heads":
        b, s, h = 4, 9, 2
    jargs, targs = _both(_wkv_inputs(b, s, h, kd, kd, seed=7, state=state,
                                     decay=decay))
    y_j, sf_j = jax_ref.ref_wkv6(*jargs)
    for y, sf in (ref.ref_wkv6(*targs), ops.wkv6(*targs),
                  rwkv.wkv6_scan(*targs)):
        assert bool(torch.isfinite(y).all())
        _close(y, y_j, 1e-5)
        _close(sf, sf_j, 1e-5)


@pytest.mark.parametrize("decay", [None, 1e-6], ids=["mid", "tiny"])
@pytest.mark.parametrize("s,h,kd,chunk", [
    (50, 2, 16, 16), (64, 2, 32, 32), (100, 1, 64, 64), (33, 3, 8, 16),
    (130, 1, 16, 32)])
def test_ref_wkv6_chunked_matches_the_pallas_kernel(s, h, kd, chunk, decay):
    """The card's chunked algebra (16-step sub-chunks through the state,
    segments of ``chunk`` steps carried across) against the Pallas kernel
    at the same chunk, ragged S included."""
    args = _wkv_inputs(2, s, h, kd, kd, seed=s + kd, decay=decay)
    jargs, targs = _both(args)
    y_p, sf_p = wkv6_pallas(*jargs, chunk=chunk, interpret=True)
    y, sf = ref.ref_wkv6_chunked(*targs, chunk=chunk)
    _close(y, y_p, 3e-4)
    _close(sf, sf_p, 3e-4)


@pytest.mark.parametrize("chunk,sub", [(16, 16), (32, 16), (64, 16),
                                       (200, 16), (24, 8), (12, 4)])
def test_ref_wkv6_chunked_matches_the_recurrence(chunk, sub):
    """Every segment and sub-chunk length, ragged last ones included,
    against JAX's step-by-step recurrence."""
    jargs, targs = _both(_wkv_inputs(2, 70, 2, 32, 32, seed=chunk + sub))
    y_j, sf_j = jax_ref.ref_wkv6(*jargs)
    y, sf = ref.ref_wkv6_chunked(*targs, chunk=chunk, sub=sub)
    _close(y, y_j, 1e-5)
    _close(sf, sf_j, 1e-5)


def _zero_decays(w, seed):
    """Decays with exact 0s, exact 1s and 1e-6 mixed in (the model's
    ``exp(-exp(decay_raw))`` is 0 in float32 once decay_raw > ~4.6)."""
    m = np.random.default_rng(seed).random(w.shape)
    w = w.copy()
    w[m < 0.2] = 0.0
    w[(m >= 0.2) & (m < 0.4)] = 1.0
    w[(m >= 0.4) & (m < 0.5)] = 1e-6
    return w


@pytest.mark.parametrize("chunk", [16, 32, 64])
def test_ref_wkv6_chunked_is_exact_at_zero_decay(chunk):
    """Decays of exactly 0: the Pallas kernel's log(0) gives NaN
    (ROADMAP C3), the step-by-step recurrence and the chunked form (which
    multiplies decays and never takes their logarithm) stay finite and
    agree."""
    args = _wkv_inputs(2, 81, 2, 16, 16, seed=chunk)
    args[3] = _zero_decays(args[3], seed=chunk)
    jargs, targs = _both(args)
    y_p, _ = wkv6_pallas(*jargs, chunk=chunk, interpret=True)
    assert not np.isfinite(np.asarray(y_p)).all()
    y_j, sf_j = jax_ref.ref_wkv6(*jargs)
    for y, sf in (ref.ref_wkv6_chunked(*targs, chunk=chunk),
                  ref.ref_wkv6(*targs)):
        assert bool(torch.isfinite(y).all() and torch.isfinite(sf).all())
        _close(y, y_j, 1e-5)
        _close(sf, sf_j, 1e-5)


@pytest.mark.parametrize("b,s,h,impl,seg", [
    (8, 1, 32, "serial", 0), (8, 4, 32, "serial", 0),
    (8, 8, 32, "chunked", 0), (8, 32, 32, "chunked", 0),
    (8, 512, 32, "chunked", 0), (8, 2048, 32, "chunked", 0),
    (4, 2048, 32, "chunked", 0), (2, 64, 32, "chunked", 0),
    (1, 127, 32, "chunked", 0), (2, 128, 32, "split", 32),
    (1, 2048, 32, "split", 256), (1, 1000, 3, "split", 16)])
def test_wkv6_instantiation_follows_length_and_grid(b, s, h, impl, seg):
    """A decode step and prefills under 8 steps take the serial kernel;
    the chunked one takes over from S 8, and the split one from S 128
    while B x H blocks fill at most half of the 132 SMs (rwkv6's B 1 x S
    2048 forward, not B 4 or 8), in segments of a multiple of 16 steps
    that give its emitting grid at most two blocks an SM."""
    from repro_torch.kernels.wkv6 import split_steps, wkv6_impl

    assert wkv6_impl(b, s, h) == impl
    if seg:
        assert split_steps(b, s, h) == seg
        assert b * h * -(-s // seg) <= 2 * 132


def test_ref_wkv6_keeps_bfloat16_outputs_and_a_float32_state():
    _, targs = _both(_wkv_inputs(1, 5, 2, 64, 64, seed=3))
    bf = [a.bfloat16() for a in targs[:5]] + [targs[5]]
    y, sf = ref.ref_wkv6(*bf)
    assert y.dtype == torch.bfloat16 and sf.dtype == torch.float32
    want, _ = ref.ref_wkv6(*[a.float() for a in bf[:5]], targs[5])
    assert (y.float() - want).abs().max().item() <= 2e-2 * max(
        1.0, want.abs().max().item())


# ---------------------------------------------------------------------------
# Blocks, model, generation
# ---------------------------------------------------------------------------


def _layer(weights, i=0):
    jp, tp = weights
    return (jax.tree.map(lambda a: a[i], jp["layers"]["rwkv"]),
            {k: (v[i] if not isinstance(v, dict) else
                 {kk: vv[i] for kk, vv in v.items()})
             for k, v in tp["layers"]["rwkv"].items()})


@pytest.mark.parametrize("carried", [False, True])
def test_time_mix_and_channel_mix_match_jax(weights, carried):
    jp, tp = _layer(weights, 1)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 6, CFG.d_model)).astype(np.float32)
    wkv = rng.standard_normal((3, 2, 64, 64)).astype(np.float32)
    shift = rng.standard_normal((3, 1, CFG.d_model)).astype(np.float32)
    jstate = (jnp.asarray(wkv), jnp.asarray(shift)) if carried else None
    tstate = ((torch.from_numpy(wkv), torch.from_numpy(shift)) if carried
              else None)
    out_j, (wkv_j, sh_j) = jax_rwkv.rwkv6_time_mix(jp, jnp.asarray(x),
                                                   jstate)
    out, (wkv_t, sh_t) = rwkv.rwkv6_time_mix(tp, torch.from_numpy(x),
                                             tstate)
    _close(out, out_j, 1e-5)
    _close(wkv_t, wkv_j, 1e-5)
    _close(sh_t, sh_j, 1e-5)
    out_j, sh_j = jax_rwkv.rwkv6_channel_mix(
        jp, jnp.asarray(x), jnp.asarray(shift) if carried else None)
    out, sh_t = rwkv.rwkv6_channel_mix(
        tp, torch.from_numpy(x), torch.from_numpy(shift) if carried else None)
    _close(out, out_j, 1e-5)
    _close(sh_t, sh_j, 1e-5)


def _prompts(n=8, seed=1):
    """Left-padded math prompts, as the static serve path feeds them."""
    ds = MathTaskDataset(prompt_len=PROMPT_LEN, level=0, seed=seed)
    return ds.sample_batch(n)[0]


def test_forward_and_decode_steps_match_jax(weights):
    jparams, params = weights
    tokens = _prompts(4)
    assert (tokens == TOK.pad_id).any()      # pads run through the scan
    jb, tb = jax_build(JCFG), build(CFG)
    want = jb.forward(jparams, jnp.asarray(tokens), return_cache=True,
                      cache_len=PROMPT_LEN + 4)
    got = tb.forward(params, torch.from_numpy(tokens), return_cache=True,
                     cache_len=PROMPT_LEN + 4)
    _close(got.logits, want.logits, 1e-4)
    _close(got.value, want.value, 1e-4)
    assert sorted(got.cache) == sorted(want.cache)
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
# Config, param tree, launchers
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    assert CFG.__dict__ == JCFG.__dict__
    assert get_config("rwkv6-1.6b").__dict__ == \
        jax_get_config("rwkv6-1.6b").__dict__


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
    lp = params["layers"]["rwkv"]
    assert "lm_head" in params and lp["bonus_u"].shape == (2, 2, 64)
    assert torch.equal(lp["decay_base"][1],
                       torch.linspace(-6.0, -1.0, CFG.d_model))


def test_param_tree_matches_jax_full_width(monkeypatch):
    """Full rwkv6-1.6b, nothing allocated: JAX by ``eval_shape``, the port
    under a fake-tensor mode (its truncated normal resamples by value, so
    it is stubbed by an empty tensor of the same shape)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    jcfg = jax_get_config("rwkv6-1.6b")
    want = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0))
    monkeypatch.setattr(layers, "_trunc_normal",
                        lambda gen, shape: torch.empty(tuple(shape)))
    with FakeTensorMode():
        got = build(get_config("rwkv6-1.6b")).init(torch.Generator())
    assert _torch_spec(got) == _spec(want)
    n = sum(x.numel() for x in tree_leaves(got))
    assert 1.58e9 < n < 1.59e9


def test_paged_functions_refuse_rwkv_with_the_reference_message():
    from repro.models.transformer import paged_arch_unsupported

    bundle = build(CFG)
    assert bundle.decode_step_paged is None
    assert bundle.init_paged_cache is None
    assert tf.paged_arch_unsupported(CFG) == paged_arch_unsupported(JCFG)
    with pytest.raises(ValueError, match="recurrent state"):
        tf.init_paged_cache(CFG, 8, 4)


@pytest.mark.parametrize("arch", ["qwen2.5-0.5b", "rwkv6-1.6b"])
def test_static_serve_launcher_runs_on_the_cpu(capsys, arch):
    from repro_torch.launch import serve

    assert serve.main(["--engine", "static", "--arch", arch, "--device",
                       "cpu", "--batch", "3", "--max-new-tokens", "4"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("decode: 12 tokens in ")
    assert out[0].endswith("tok/s on this host's CPU)")
    assert len(out) == 4 and all("(gold " in line for line in out[1:])


def test_continuous_engine_refuses_rwkv_with_the_reference_message():
    from repro.models.transformer import paged_arch_unsupported
    from repro_torch.launch import serve

    with pytest.raises(ValueError) as err:
        serve.main(["--engine", "continuous", "--arch", "rwkv6-1.6b",
                    "--device", "cpu", "--requests", "1"])
    assert paged_arch_unsupported(JCFG) in str(err.value)


def test_train_launcher_refuses_rwkv():
    from repro_torch.launch import train

    with pytest.raises(SystemExit, match="wkv6 kernel, which is not ported"):
        train.main(["rlvr", "--arch", "rwkv6-1.6b", "--device", "cpu"])
