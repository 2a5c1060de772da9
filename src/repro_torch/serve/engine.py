"""Continuous-batching serve engine over the paged KV cache (port of
``repro.serve.engine``, the default chunked-prefill path).

One :meth:`ServeEngine.step` is one scheduling round: the scheduler
admits / preempts / extends, then either

* a **chunked varlen round** runs while any admission still has prompt
  rows to prefill: every decode-eligible slot's single-token row and
  the pending prefill tiles (``prefill_chunk`` rows each, bounded by
  ``dispatch_budget`` tokens with decode rows reserved first) go through
  one ``decode_step_paged_varlen`` pass; or
* a **decode chunk** of ``decode_chunk`` single-token steps runs over
  every active slot, with EOS and per-request budget termination on the
  device.

Round layouts (``t_pad`` rounding, decode-rows-first budget, FIFO tile
order) are the JAX engine's, row for row, so greedy output is
token-exact against it on the same weights.  Requests retire the moment
they emit EOS or reach ``max_new_tokens``; preemption recomputes KV
(re-prefill over prompt + emitted tokens) and never retracts tokens.
Every emitted token carries its ``log_beta`` and policy version.

**In-flight weight swap.**  Over a ``runtime.PolicyStore`` the engine
reads the store's newest version every ``swap_interval`` steps, at the
head of :meth:`step`: between rounds, never inside a decode chunk or a
varlen round, so a request's ``versions`` is a step function across the
swap.  The swap is a host-side pointer change: the store lives on the
engine's device and the engine generates from the store's own tensors
under a hold (``PolicyStore.hold``), which keeps them intact when later
publishes overwrite their ring slot.  ``swap_interval=0`` never polls:
weights then move only by :meth:`set_version` (the forced-lag serve
producer).  An engine stepped on another thread than the publisher's
(the threaded regimes) calls :meth:`use_private_weights` first: from
then on a swap copies the version into the engine's own buffers under
the store's lock (``PolicyStore.snapshot``), since a hold re-points its
tree in place, which is safe only on the publisher's thread.

**Device.**  The engine runs on ``cuda`` unless ``device="cpu"`` is
passed; without CUDA and without ``device="cpu"`` it raises.  On CUDA
the paged kernels are the hand-written CUDA ones; on the CPU their plain
versions.  The pool tensors are updated in place.

**Host syncs.**  A decode chunk is a Python loop over device tensors
with no device-to-host copy inside it; its tokens, log-probs and masks
come back in one copy when the chunk ends.  A varlen round also ends in
one copy.

Not ported yet, and refused with ``NotImplementedError``:
``speculate_k > 0``, ``prefix_cache=True``, ``mesh`` and
``chunked_prefill=False``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.metrics.runtime_metrics import collect_serve_stats
from repro_torch.models.registry import ModelBundle
from repro_torch.models.transformer import paged_arch_unsupported, tree_to
from repro_torch.obs.perfetto import trace_annotation
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.resilience import NULL_INJECTOR, FaultInjector
from repro_torch.rollout.sampler import gumbel_noise, sample
from repro_torch.serve.paged_cache import make_allocator
from repro_torch.serve.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.utils.tree import tree_leaves


@dataclass(frozen=True)
class ServedTrajectory:
    """A finished request with per-token provenance (see the JAX
    ``ServedTrajectory``)."""

    request_id: int
    prompt: np.ndarray          # [P] int32
    tokens: np.ndarray          # [N] int32 (includes EOS when emitted)
    log_beta: np.ndarray        # [N] float32 behavior log-probs
    versions: np.ndarray        # [N] int64 producing policy versions
    mask: np.ndarray            # [N] float32 (all ones; EOS is scored)
    finish_reason: str          # "eos" | "length" | "timeout"
    latency_s: float            # submit -> finish wall time
    num_preemptions: int

    @property
    def behavior_version(self) -> int:
        return int(self.versions.min()) if self.versions.size else 0

    @property
    def num_tokens(self) -> int:
        return int(self.tokens.shape[0])


@dataclass
class ServeStats:
    steps: int = 0               # scheduling rounds
    decode_steps: int = 0        # decode iterations
    prefills: int = 0            # requests prefilled
    prefill_dispatches: int = 0  # varlen rounds that carried prefill tiles
    finished: int = 0
    tokens_out: int = 0
    preemptions: int = 0
    swaps: int = 0
    occupancy_sum: float = 0.0   # emitting slots summed over decode steps
    # Kept for collect_serve_stats parity with the JAX engine; the port
    # has no speculation or prefix cache yet, so these stay 0.
    spec_rounds: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    prefill_tokens: int = 0      # KV rows computed by prefill tiles
    cow_copies: int = 0
    timeouts: int = 0
    spec_autodisables: int = 0

    def as_dict(self) -> Dict[str, Any]:
        d = dict(self.__dict__)
        d["mean_occupancy"] = (self.occupancy_sum / self.decode_steps
                               if self.decode_steps else 0.0)
        d["acceptance_rate"] = (self.accepted_tokens / self.drafted_tokens
                                if self.drafted_tokens else 0.0)
        return d


def resolve_device(device: Any = None) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; raises when CUDA is
    wanted and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class ServeEngine:
    """Paged-KV continuous-batching generation over a ModelBundle."""

    def __init__(
        self,
        bundle: ModelBundle,
        params: Any = None,
        *,
        num_blocks: int = 64,
        block_size: int = 8,
        max_batch: int = 4,
        max_seq_len: int = 256,
        decode_chunk: int = 1,
        store: Any = None,
        swap_interval: int = 1,
        temperature: float = 1.0,
        top_p: float = 1.0,
        seed: int = 0,
        speculate_k: int = 0,
        chunked_prefill: bool = True,
        prefill_chunk: int = 16,
        dispatch_budget: int = 32,
        mesh: Any = None,
        prefix_cache: bool = False,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        annotate: bool = False,
        injector: Optional[FaultInjector] = None,
        request_deadline_s: Optional[float] = None,
        device: Any = None,
    ) -> None:
        """Arguments follow the JAX ``ServeEngine``; ``device`` picks
        ``cuda`` (default) or ``cpu``.  ``store`` (a
        ``runtime.PolicyStore`` on that device) replaces ``params``: the
        engine starts from its newest version.  ``annotate=True`` wraps
        each dispatch in ``torch.profiler.record_function``."""
        for flag, on in (("speculate_k > 0", speculate_k > 0),
                         ("prefix_cache=True", bool(prefix_cache)),
                         ("mesh", mesh is not None),
                         ("chunked_prefill=False", not chunked_prefill)):
            if on:
                raise NotImplementedError(
                    f"ServeEngine: {flag} is not ported yet")
        reason = paged_arch_unsupported(bundle.cfg)
        if bundle.decode_step_paged is None or reason is not None:
            raise ValueError(f"{bundle.cfg.name}: {reason}")
        if params is None and store is None:
            raise ValueError("need params or a PolicyStore")
        self.device = resolve_device(device)
        if store is not None:
            where = tree_leaves(store.buffer.stacked)[0].device
            if where != torch.empty(0, device=self.device).device:
                raise ValueError(
                    f"the PolicyStore's snapshots are on {where}, the "
                    f"engine runs on {self.device}; build the store on "
                    "the engine's device (a swap copies no weights)")
        self.store = store
        self.injector = injector if injector is not None else NULL_INJECTOR
        self.bundle = bundle
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.metrics.register_producer(
            "serve", lambda: collect_serve_stats(self))
        self._h_ttft = self.metrics.histogram("serve_ttft_s")
        self._h_ttft_queue = self.metrics.histogram("serve_ttft_queue_s")
        self._h_ttft_prefill = self.metrics.histogram("serve_ttft_prefill_s")
        self._h_inter_token = self.metrics.histogram("serve_inter_token_s")
        self._h_queue_wait = self.metrics.histogram("serve_queue_wait_s")
        self._h_latency = self.metrics.histogram("serve_request_latency_s")
        self._h_swap_stale = self.metrics.histogram("serve_swap_to_stale_s")
        self._swap_mono: Optional[float] = None   # last in-flight swap
        self._ann = (trace_annotation if annotate
                     else (lambda name: contextlib.nullcontext()))
        self.swap_interval = max(int(swap_interval), 0)
        self._private = False
        if store is not None:
            self.params, self.version = store.hold()
        else:
            self.params, self.version = tree_to(params, self.device), 0
        self.block_size = block_size
        max_blocks_per_request = -(-max_seq_len // block_size)
        self.allocator = make_allocator(num_blocks, block_size, 1,
                                        tracer=self.tracer)
        windows = [bundle.cfg.window_for_layer(layer)
                   for layer in range(bundle.cfg.n_layers)]
        self._reclaim_window = (
            max(windows) if windows and all(w is not None for w in windows)
            else None)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, max_batch=max_batch,
            max_blocks_per_request=max_blocks_per_request,
            reclaim_window=self._reclaim_window, tracer=self.tracer,
            request_deadline_s=request_deadline_s, registry=self.metrics)
        self.pages = bundle.init_paged_cache(num_blocks, block_size,
                                             device=self.device)
        self.max_batch = max_batch
        self._tables = np.zeros((max_batch, max_blocks_per_request), np.int32)
        self._pos = np.zeros((max_batch,), np.int32)
        self._active = np.zeros((max_batch,), bool)
        self._last_tok = np.zeros((max_batch,), np.int32)
        self.stats = ServeStats()
        self._temperature = max(float(temperature), 1e-6)
        self._top_p = float(top_p)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.decode_chunk = max(int(decode_chunk), 1)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.dispatch_budget = max(int(dispatch_budget), 1)

    # -- request intake ------------------------------------------------------

    def submit(self, prompt: Sequence[int] | np.ndarray,
               max_new_tokens: int,
               request_id: Optional[int] = None) -> Request:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        kw = {} if request_id is None else {"request_id": request_id}
        req = Request(prompt=prompt, max_new_tokens=max_new_tokens, **kw)
        self.scheduler.submit(req)
        return req

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    # -- in-flight weight swap ------------------------------------------------

    def use_private_weights(self) -> None:
        """Generate from a private copy of the store's versions from now
        on, on the thread that steps the engine: the held version is
        copied once into buffers of the engine's own, and each later
        swap copies into them in place."""
        if self.store is None or self._private:
            return
        params, _ = self.store.snapshot(self.version)
        self.store.unhold(self.version)
        self.params, self._private = params, True

    def set_version(self, version: int) -> None:
        """Generate from the store's ``version`` from the next dispatch
        on, holding it (and dropping the hold on the version before), or
        copying it into the private buffers."""
        if self._private:
            _, version = self.store.snapshot(version, out=self.params)
            self.version = version
            return
        params, version = self.store.hold(version)
        self.store.unhold(self.version)
        self.params, self.version = params, version

    def _maybe_swap(self) -> None:
        if self.store is None or not self.swap_interval:
            return
        if self.stats.steps % self.swap_interval != 0:
            return
        old = self.version
        if self._private:
            # Copy only when there is something newer to copy.
            if self.store.latest_version() == old:
                return
            _, version = self.store.snapshot(out=self.params)
        else:
            self.params, version = self.store.hold()
            self.store.unhold(old)
        if version == old:
            return
        self.version = version
        self.stats.swaps += 1
        # Swap-to-first-stale-token latency: armed here, observed by the
        # next _record (whose token carries the new version).
        self._swap_mono = time.monotonic()
        tr = self.tracer
        if tr.enabled:
            tr.instant("swap", tid="engine", old=old, new=version)

    # -- internals -----------------------------------------------------------

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device (never a view
        of the engine's mutable host state)."""
        return torch.tensor(arr, device=self.device)

    def _sample(self, logits: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        noise = gumbel_noise(logits.shape, self._gen, logits.device)
        return sample(logits, self._temperature, self._top_p, noise)

    @staticmethod
    def _committed_ids(req: Request) -> np.ndarray:
        """prompt + all emitted tokens except the pending one — exactly
        the rows a (re)prefill must make resident."""
        if not req.tokens:
            return req.prompt
        return np.concatenate(
            [req.prompt, np.asarray(req.tokens[:-1], np.int32)])

    def _record(self, req: Request, tok: int, lp: float,
                finished: List[ServedTrajectory]) -> None:
        """Book one emitted token; retire the request when done."""
        now = time.monotonic()
        if req.first_token_time is None:
            req.first_token_time = now
            self._h_ttft.observe(now - req.submit_time)
            if req.admit_time is not None:
                self._h_ttft_queue.observe(req.admit_time - req.submit_time)
                self._h_ttft_prefill.observe(now - req.admit_time)
        else:
            self._h_inter_token.observe(now - req.last_emit_time)
        req.last_emit_time = now
        if self._swap_mono is not None:
            # First token after an in-flight swap.
            self._h_swap_stale.observe(now - self._swap_mono)
            self._swap_mono = None
        req.tokens.append(tok)
        req.log_beta.append(lp)
        req.versions.append(self.version)
        self.stats.tokens_out += 1
        tr = self.tracer
        if tr.full:
            lag = (self.store.version - self.version
                   if self.store is not None else 0)
            tr.instant("token", tid="tokens", rid=req.request_id,
                       v=self.version, lag=lag, tok=tok)
        if tok == EOS:
            self._finish(req, "eos", finished)
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(req, "length", finished)
        else:
            self._last_tok[req.slot] = tok

    def _trajectory(self, req: Request, reason: str,
                    latency: float) -> ServedTrajectory:
        n = len(req.tokens)
        return ServedTrajectory(
            request_id=req.request_id,
            prompt=req.prompt,
            tokens=np.asarray(req.tokens, np.int32),
            log_beta=np.asarray(req.log_beta, np.float32),
            versions=np.asarray(req.versions, np.int64),
            mask=np.ones((n,), np.float32),
            finish_reason=reason,
            latency_s=latency,
            num_preemptions=req.num_preemptions,
        )

    def _finish(self, req: Request, reason: str,
                finished: List[ServedTrajectory]) -> None:
        slot = req.slot
        self.scheduler.retire(req, reason)
        self._clear_slot(slot)
        self.stats.finished += 1
        latency = req.finish_time - req.submit_time
        self._h_latency.observe(latency)
        finished.append(self._trajectory(req, reason, latency))

    def _timeout_finish(self, req: Request,
                        finished: List[ServedTrajectory]) -> None:
        """Book a deadline-expired request (already retired by the
        scheduler) as a ``finish_reason="timeout"`` trajectory."""
        self._clear_slot(req.slot)
        self.stats.finished += 1
        self.stats.timeouts += 1
        latency = (req.finish_time or time.monotonic()) - req.submit_time
        self._h_latency.observe(latency)
        finished.append(self._trajectory(req, "timeout", latency))

    def _clear_slot(self, slot: Optional[int]) -> None:
        if slot is None:
            return
        self._active[slot] = False
        self._tables[slot] = 0
        self._pos[slot] = 0
        self._last_tok[slot] = 0

    # -- chunked ragged prefill ----------------------------------------------

    def _varlen(self, tokens: np.ndarray, row_start: np.ndarray,
                row_len: np.ndarray, cap: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """One unified ragged pass; samples each slot's next token from
        the logits of its last live row.  Returns host (tokens, log_beta)
        after one device-to-host copy."""
        t_pad = tokens.shape[1]
        row_len_d = self._to_dev(row_len)
        out, self.pages = self.bundle.decode_step_paged_varlen(
            self.params, self._to_dev(tokens), self.pages,
            self._to_dev(self._tables), self._to_dev(row_start), row_len_d,
            self._to_dev(cap))
        last = torch.clamp(row_len_d - 1, 0, t_pad - 1).long()
        logits = torch.gather(
            out.logits, 1,
            last[:, None, None].expand(-1, 1, out.logits.shape[-1]))[:, 0]
        tok, lp = self._sample(logits)
        both = torch.stack([tok.double(), lp.double()]).cpu().numpy()
        return both[0].astype(np.int32), both[1].astype(np.float32)

    def _chunked_round(self, finished: List[ServedTrajectory]) -> bool:
        """One unified varlen round, or False when no prefill is pending.

        Every decode-eligible slot's single-token row is reserved out of
        ``dispatch_budget`` first; the remainder goes to prefill tiles of
        at most ``prefill_chunk`` rows, FIFO by admission order, with a
        one-row floor for the oldest tile so admission always progresses.
        """
        pending = [r for r in self.scheduler.running if not r.prefill_done]
        if not pending:
            return False
        tr = self.tracer
        bs = self.block_size
        order = {id(r): i for i, r in
                 enumerate(self.scheduler._admission_order)}
        ready = sorted(pending, key=lambda r: order[id(r)])
        decode_reqs = [r for r in self.scheduler.running if r.prefill_done]
        budget_left = self.dispatch_budget - len(decode_reqs)
        chunks: List[Tuple[Request, np.ndarray, int]] = []
        for r in ready:
            ids = self._committed_ids(r)
            left = int(ids.shape[0]) - r.num_prefilled
            n = min(self.prefill_chunk, left, budget_left)
            if n <= 0:
                if chunks:
                    continue
                n = 1    # floor: the oldest ready tile always advances
            budget_left -= n
            chunks.append((r, ids, n))
        t_max = max([n for _, _, n in chunks], default=1)
        t_pad = -(-t_max // 4) * 4     # same padding as the JAX engine
        B = self.max_batch
        tokens = np.full((B, t_pad), PAD, np.int32)
        row_start = np.zeros((B,), np.int32)
        row_len = np.zeros((B,), np.int32)
        cap = np.zeros((B,), np.int32)
        for r in decode_reqs:
            s = r.slot
            tokens[s, 0] = self._last_tok[s]
            row_start[s] = self._pos[s]
            row_len[s] = 1
            cap[s] = len(r.blocks) * bs
        for r, ids, n in chunks:
            s = r.slot
            tokens[s, :n] = ids[r.num_prefilled:r.num_prefilled + n]
            row_start[s] = r.num_prefilled
            row_len[s] = n
            cap[s] = len(r.blocks) * bs
        n_tile_tokens = sum(n for _, _, n in chunks)
        with tr.span("chunked_round", tid="engine",
                     decode=len(decode_reqs), tiles=len(chunks),
                     tokens=int(row_len.sum())), \
                self._ann("serve.chunked_round"):
            toks_np, lps_np = self._varlen(tokens, row_start, row_len, cap)
        self.stats.prefill_dispatches += 1
        self.stats.prefill_tokens += n_tile_tokens
        if decode_reqs:
            self.stats.decode_steps += 1
            self.stats.occupancy_sum += float(len(decode_reqs))
        for r, ids, n in chunks:
            slot = r.slot
            r.num_prefilled += n
            self._pos[slot] = r.num_prefilled
            if r.num_prefilled >= int(ids.shape[0]):
                # Last chunk landed: the slot becomes decode-eligible and
                # this round's token is its first emission, unless the
                # request resumes after preemption (its pending token was
                # recorded before).
                r.prefill_done = True
                self._active[slot] = True
                self.stats.prefills += 1
                if r.tokens:
                    self._last_tok[slot] = r.tokens[-1]
                else:
                    self._record(r, int(toks_np[slot]),
                                 float(lps_np[slot]), finished)
        for r in decode_reqs:
            slot = r.slot
            self._pos[slot] += 1
            self._record(r, int(toks_np[slot]), float(lps_np[slot]),
                         finished)
        return True

    # -- the decode chunk ----------------------------------------------------

    def _decode(self, remaining: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``decode_chunk`` decode steps over every active slot.

        Rows terminate on the device (EOS, or the request's budget via
        ``remaining``); a retired row idles masked until the chunk ends.
        No device-to-host copy happens inside the loop; the chunk's
        tokens, log-probs and masks come back in one copy at the end.
        Returns host arrays ``[chunk, B]``."""
        token = self._to_dev(self._last_tok)
        tables = self._to_dev(self._tables)
        pos = self._to_dev(self._pos)
        active = self._to_dev(self._active)
        remaining = self._to_dev(remaining)
        emitted = torch.zeros_like(pos)
        pad = torch.full_like(token, PAD)
        rows = []
        for _ in range(self.decode_chunk):
            out, self.pages = self.bundle.decode_step_paged(
                self.params, token, self.pages, tables, pos, active)
            tok, lp = self._sample(out.logits)
            mask = active
            tok = torch.where(active, tok, pad)
            lp = torch.where(active, lp, torch.zeros_like(lp))
            step = active.to(torch.int32)
            pos = pos + step
            emitted = emitted + step
            active = active & (tok != EOS) & (emitted < remaining)
            token = tok
            rows.append(torch.stack([tok.double(), lp.double(),
                                     mask.double()]))
        host = torch.stack(rows).cpu().numpy()        # [chunk, 3, B]
        return (host[:, 0].astype(np.int32), host[:, 1].astype(np.float32),
                host[:, 2] > 0)

    def step(self) -> List[ServedTrajectory]:
        """One scheduling round + decode chunk (or varlen round);
        returns newly finished trajectories."""
        finished: List[ServedTrajectory] = []
        tr = self.tracer
        self._maybe_swap()
        self.stats.steps += 1
        # Deadline sweep before scheduling: expired waiting requests are
        # never admitted, expired running ones free their slot and pages.
        for req in self.scheduler.expire():
            self._timeout_finish(req, finished)
        with tr.span("schedule", tid="engine"):
            admitted, _ = self.scheduler.schedule(lookahead=self.decode_chunk)
        self.stats.preemptions = self.scheduler.preemptions
        if admitted:
            now = time.monotonic()
            for req in admitted:
                self._h_queue_wait.observe(now - req.queued_time)
                req.admit_time = now
        # Admissions stream in as ragged tiles over the next rounds: mark
        # them pending and park the write cursor at the first row.
        for req in admitted:
            req.prefill_done = False
            self._pos[req.slot] = req.num_prefilled
        # Rebuild slot state from the scheduler: preempted/retired slots
        # go quiet, running rows pick up pages the extension just granted.
        by_slot = {r.slot: r for r in self.scheduler.running}
        remaining = np.zeros((self.max_batch,), np.int32)
        for slot in range(self.max_batch):
            req = by_slot.get(slot)
            if req is None:
                self._clear_slot(slot)
            else:
                self._active[slot] = req.prefill_done
                self._tables[slot] = self.allocator.padded_table(
                    req.blocks, self._tables.shape[1])
                remaining[slot] = req.max_new_tokens - len(req.tokens)
        if tr.enabled:
            sched = self.scheduler
            tr.counter("serve_load", waiting=float(len(sched.waiting)),
                       running=float(len(sched.running)))
            tr.counter("pool_free", free=float(self.allocator.num_free))
            if self.store is not None:
                tr.counter("policy_lag",
                           lag=float(self.store.version - self.version))
        if self._chunked_round(finished):
            return finished
        if not self._active.any():
            return finished
        with tr.span("decode", tid="engine", chunk=self.decode_chunk), \
                self._ann("serve.decode"):
            toks_np, lps_np, masks_np = self._decode(remaining)
        self.stats.occupancy_sum += float(masks_np.sum())
        self.stats.decode_steps += self.decode_chunk
        for req in list(self.scheduler.running):
            slot = req.slot
            self._pos[slot] += int(masks_np[:, slot].sum())
            for t in range(self.decode_chunk):
                if not masks_np[t, slot]:
                    break
                self._record(req, int(toks_np[t, slot]),
                             float(lps_np[t, slot]), finished)
        return finished

    def run(self, max_steps: Optional[int] = None
            ) -> List[ServedTrajectory]:
        """Step until every submitted request finished (or max_steps)."""
        out: List[ServedTrajectory] = []
        steps = 0
        while self.has_work:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return out
