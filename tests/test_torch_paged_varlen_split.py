"""The ragged paged attention split over the context (the card's routine
above head dim 128, ``csrc/paged_attention_varlen.cu``'s
``varlen_d256_kernel``) in its plain form,
``kernels.ref.ref_paged_attention_varlen_split``, against JAX's Pallas
varlen kernel in interpret mode, ``repro.kernels.ref``'s varlen oracle
and ``kernels.ref.ref_paged_attention_varlen``; and the host planner of
the split count and the block's tiles.  Numpy inputs from a seed go to
both packages; float32 within 2e-5.  Head dims 64 and 256, groups of 1, 2
and 7, global and windowed attention, ragged rows with an idle slot and
padding rows, blocks of 16, 32 and 64 rows, split counts from 1 to 32.
The kernel itself on the card: ``tests/test_torch_cuda_d256.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention_pallas import \
    paged_attention_varlen as pallas_paged_attention_varlen
from repro.kernels.ref import \
    ref_paged_attention_varlen as jax_ref_paged_attention_varlen
from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import SPLIT_MAX, split_chunk
from repro_torch.kernels.paged_attention_varlen import (VARLEN_BLOCK_ROWS,
                                                        VARLEN_MIN_KEYS,
                                                        VARLEN_STAGE_KEYS,
                                                        plan_varlen_splits,
                                                        varlen_splits)

torch.set_num_threads(1)

TOL = 2e-5
BS = 8
T = 12
# (row_start, row_len) a slot: one decode row, a whole chunk of T rows, a
# chunk from position 0, an idle slot, a chunk past a window of 16 at
# contexts to 82.
ROWS = [(40, 1), (16, T), (0, 7), (9, 0), (70, T)]
SPLITS = [1, 2, 3, 5, 8, 16, 32]
_WANT = {}


def _inputs(d, h, kv):
    """Pools of distinct shuffled pages for ROWS' contexts, q [B, T, H, d]
    and the block tables, from a seed."""
    rng = np.random.default_rng(d * 100 + h * 10 + kv + 7)
    ctx = [a + n for a, n in ROWS]
    m = max(-(-c // BS) for c in ctx)
    nb = len(ROWS) * m + 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(ROWS), m), np.int32)
    for i, c in enumerate(ctx):
        pages = -(-c // BS)
        tables[i, :pages] = perm[i * m:i * m + pages]
    kp, vp = (rng.standard_normal((kv, nb, BS, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((len(ROWS), T, h, d)).astype(np.float32)
    start = np.asarray([a for a, _ in ROWS], np.int32)
    lens = np.asarray([n for _, n in ROWS], np.int32)
    return q, kp, vp, tables, start, lens


def _want(d, h, kv, window):
    """(inputs, Pallas in interpret mode, JAX's oracle), once a case."""
    key = (d, h, kv, window)
    if key not in _WANT:
        args = _inputs(d, h, kv)
        jargs = [jnp.asarray(a) for a in args]
        _WANT[key] = (args, np.asarray(pallas_paged_attention_varlen(
            *jargs, window=window, interpret=True)),
            np.asarray(jax_ref_paged_attention_varlen(*jargs,
                                                      window=window)))
    return _WANT[key]


@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("h,kv", [(2, 2), (4, 2), (7, 1)])
@pytest.mark.parametrize("d", [64, 256])
def test_plain_split_varlen_matches_pallas(d, h, kv, window):
    """Every split count from 1 to 32 and blocks of 16, 32 and 64 packed
    rows, with the kernel's chunks (floor ``VARLEN_MIN_KEYS``, whole
    stages of ``VARLEN_STAGE_KEYS``: most splits of these short spans see
    no key) and with one-key chunks (every split of a long enough span
    sees keys, and most rows see none of a split's keys), against the
    Pallas kernel, JAX's oracle and the port's unsplit plain version;
    padding rows and the idle slot exactly zero."""
    args, pallas, oracle = _want(d, h, kv, window)
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    plain = ref.ref_paged_attention_varlen(*t, window=window).numpy()
    np.testing.assert_allclose(plain, pallas, rtol=0, atol=TOL)
    for block_rows in (16, 32, 64):
        for n in SPLITS:
            for min_keys, stage in ((VARLEN_MIN_KEYS, VARLEN_STAGE_KEYS),
                                    (1, 1)):
                got = ref.ref_paged_attention_varlen_split(
                    *t, window=window, n_splits=n, min_keys=min_keys,
                    stage=stage, block_rows=block_rows).numpy()
                np.testing.assert_allclose(got, pallas, rtol=0, atol=TOL)
                np.testing.assert_allclose(got, oracle, rtol=0, atol=TOL)
                np.testing.assert_allclose(got, plain, rtol=0, atol=TOL)
                for i, (_, n_rows) in enumerate(ROWS):
                    np.testing.assert_array_equal(got[i, n_rows:], 0.0)


@pytest.mark.parametrize("n", SPLITS)
def test_varlen_split_chunks_cover_the_span_once(n):
    """The splits that see a key tile a block's span exactly: chunks of
    at least the floor, in whole 32-key stages; the last may be short;
    the rest of the ``n`` splits see nothing."""
    for span in (1, 32, 63, 64, 65, 1055, 2016, 2048):
        chunk = split_chunk(span, n, VARLEN_MIN_KEYS, VARLEN_STAGE_KEYS)
        assert chunk % VARLEN_STAGE_KEYS == 0 and chunk >= VARLEN_MIN_KEYS
        used = -(-span // chunk)
        assert 1 <= used <= n
        assert (used - 1) * chunk < span <= used * chunk


def test_varlen_planner_short_spans_take_one_split():
    """A span up to the floor of keys a split takes one split, whatever
    the grid; a table of a few pages takes one split."""
    for groups in (1, 8, 32, 256):
        for span in (1, 17, 45, VARLEN_MIN_KEYS):
            assert plan_varlen_splits(groups, span, 132) == 1
    assert plan_varlen_splits(1, VARLEN_MIN_KEYS + 1, 132) == 2
    assert varlen_splits(16, 16, 8, 8, 8, None, 132) == 1


def test_varlen_planner_splits_the_long_chunk():
    """Phase 41's long prompt in 64-row chunks (16 / 8 heads of 256,
    tables of 260 pages): a slot's 128 rows in four blocks of
    ``VARLEN_BLOCK_ROWS``, whose 8 x 4 blocks times the splits fill an
    H100's 132 SMs once (4 splits: 128 blocks), and every split of the
    last round's blocks sees keys, global and past the window of 1024; a
    decode or verify round (one block a slot and kv head) takes 16; never
    more than ``SPLIT_MAX`` splits."""
    assert VARLEN_BLOCK_ROWS == 32
    for window, spans in ((None, (1999, 2048)), (1024, (1039, 1039))):
        n = varlen_splits(64, 16, 8, 260, 8, window, 132)
        assert n == 4 and 8 * 4 * n <= 132
        for span in spans:   # the last round's first and last blocks
            chunk = split_chunk(span, n, VARLEN_MIN_KEYS, VARLEN_STAGE_KEYS)
            assert -(-span // chunk) == n
    assert varlen_splits(4, 16, 8, 260, 8, None, 132) == 16
    assert varlen_splits(2048, 16, 8, 260, 8, None, 132) == 1
    assert varlen_splits(4, 4, 4, 260, 8, None, 132) == SPLIT_MAX
