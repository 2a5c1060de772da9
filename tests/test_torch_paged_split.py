"""The paged decode split over the context (the card's routine above head
dim 128, ``csrc/paged_attention_split.cuh``) in its plain form,
``kernels.ref.ref_paged_attention_split``, against JAX's Pallas paged
kernel in interpret mode and ``repro.kernels.ref.ref_paged_attention``;
and the host planner of the split count.  Numpy inputs from a seed go to
both packages; float32 within 2e-5.  Head dims 64 and 256, groups of 1,
2 and 7, global and windowed attention, ``ctx`` 0, splits that see no
key, split counts from 1 to 32.  The kernel itself on the card:
``tests/test_torch_cuda_d256.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention_pallas import \
    paged_attention as pallas_paged_attention
from repro.kernels.ref import ref_paged_attention as jax_ref_paged_attention
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import (SPLIT_MAX, SPLIT_MIN_KEYS,
                                                 SPLIT_STAGE_KEYS,
                                                 plan_splits, split_chunk,
                                                 split_geometry)

torch.set_num_threads(1)

TOL = 2e-5
BS = 8
# Contexts: past a window of 16, one of exactly a page, an idle slot, a
# single key.
LENS = [45, 17, 0, 70, 1]
SPLITS = [1, 2, 3, 5, 8, 16, 32]
_WANT = {}


def _inputs(d, h, kv):
    """Pools of distinct shuffled pages for LENS, a query [B, H, d] and
    the block tables, from a seed."""
    rng = np.random.default_rng(d * 100 + h * 10 + kv)
    m = max(-(-n // BS) for n in LENS)
    nb = len(LENS) * m + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(LENS), m), np.int32)
    for i, n in enumerate(LENS):
        pages = -(-n // BS)
        tables[i, :pages] = perm[i * m:i * m + pages]
    kp, vp = (rng.standard_normal((kv, nb, BS, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((len(LENS), h, d)).astype(np.float32)
    return q, kp, vp, tables, np.asarray(LENS, np.int32)


def _want(d, h, kv, window):
    """(inputs, Pallas in interpret mode, JAX's oracle), once a case."""
    key = (d, h, kv, window)
    if key not in _WANT:
        args = _inputs(d, h, kv)
        jargs = [jnp.asarray(a) for a in args]
        _WANT[key] = (args, np.asarray(pallas_paged_attention(
            *jargs, window=window, interpret=True)),
            np.asarray(jax_ref_paged_attention(*jargs, window=window)))
    return _WANT[key]


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (7, 1)])
@pytest.mark.parametrize("d", [64, 256])
def test_plain_split_decode_matches_pallas(d, h, kv, window):
    """Every split count from 1 to 32, with the kernel's chunks (floor
    ``SPLIT_MIN_KEYS``, whole stages of ``SPLIT_STAGE_KEYS``: most splits
    of these short contexts see no key) and with one-key chunks (every
    split of a long enough context sees keys), against the Pallas kernel
    and JAX's oracle; the idle slot exactly zero."""
    args, pallas, oracle = _want(d, h, kv, window)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    for n in SPLITS:
        for min_keys, stage in ((SPLIT_MIN_KEYS, SPLIT_STAGE_KEYS), (1, 1)):
            got = ref.ref_paged_attention_split(
                *t, window=window, n_splits=n, min_keys=min_keys,
                stage=stage).numpy()
            np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
            np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)
            np.testing.assert_array_equal(got[LENS.index(0)], 0.0)


@pytest.mark.parametrize("n", SPLITS)
def test_split_chunks_cover_the_span_once(n):
    """The splits that see a key tile the visible span exactly: chunks of
    at least the floor, in whole stages; the last may be short; the rest
    of the ``n`` splits see nothing."""
    for span in (1, 16, 47, 48, 49, 1024, 2064):
        chunk = split_chunk(span, n)
        assert chunk % SPLIT_STAGE_KEYS == 0 and chunk >= SPLIT_MIN_KEYS
        used = -(-span // chunk)
        assert 1 <= used <= n
        assert (used - 1) * chunk < span <= used * chunk


def test_planner_short_contexts_take_one_split():
    """A span up to the floor of keys a split takes one split, whatever
    the grid (the decode contexts 45/17/64/33); one key more takes two."""
    for groups in (1, 8, 32, 256):
        for span in (1, 17, 45, SPLIT_MIN_KEYS):
            assert plan_splits(groups, span, 132) == 1
    assert plan_splits(32, SPLIT_MIN_KEYS + 1, 132) == 2


def test_planner_fills_the_card_past_the_window():
    """At the long prompt's B 1 (8 kv heads) past gemma3's window of 1024
    the splits give a block, with keys, to all but fewer than a group's
    worth of the 132 SMs of an H100 (16 splits of 64 keys: 128 blocks;
    the 22 of 48 keys that would cover all 132 put two blocks on 44 SMs
    and ran slower on the card); at B 4 about two blocks an SM; never
    more than ``SPLIT_MAX`` splits, and a global B 1 layer over 2,064
    keys takes the most."""
    b1 = split_geometry(1, 16, 8, 258, 8, 1024, 132)
    assert 132 - 8 < 8 * b1 <= 132
    assert -(-1024 // split_chunk(1024, b1)) == b1   # every split has keys
    b4 = split_geometry(4, 16, 8, 258, 8, 1024, 132)
    assert 132 <= 32 * b4 <= 2 * 132 + 32
    assert split_geometry(1, 16, 8, 258, 8, None, 132) == SPLIT_MAX
    # The window caps the span a table could hold; a narrow table caps it
    # below the window.
    assert split_geometry(4, 16, 8, 6, 8, 1024, 132) == 1
    # Groups above 8 heads take row tiles of their own.
    assert split_geometry(1, 32, 2, 258, 8, 1024, 132) == \
        plan_splits(4, 1024, 132)
