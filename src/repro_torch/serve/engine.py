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

**Speculative decode** (``speculate_k > 0``).  A draft proposes ``k``
tokens a slot and the verifier scores them in one
``decode_step_paged_multi`` pass (the varlen kernel at ``T = k``),
keeping a prefix by the Leviathan rule (``rollout.sampler.
speculative_accept``).  The draft is a lagged store version (self-
speculation, pinned), fixed params, a separate model, or a host
callable.  Model drafts keep their own paged pool addressed by the
verifier's block tables, so a rejection rewinds ``pos`` on both and
emits no page copy.  Emitted tokens, their ``log_beta`` and versions
are the verifier's, so greedy speculative output equals plain greedy
output.  ``speculate_adaptive`` picks each round's ``k`` from the slots'
acceptance EMA; ``spec_disable_after`` all-reject rounds in a row turn
speculation off.  Draws follow the JAX engine's key order: a model
draft's ``k`` sampling draws, then the verify pass's ``(u, gumbel)``.

**Prefix cache** (``prefix_cache=True``).  Full pages are content-
addressed (a chained hash over the ids, salted with the policy version
and the arch) and refcounted; an admission whose committed ids extend a
resident prefix shares those pages and prefills only its suffix.  A
match that ends mid-page is copied into the request's own page
(``copy_page_rows``, both pools) right before its first tile, and a
pending request whose shared pages another request is still computing
waits for them.  A swap invalidates entries through the salt alone.

**Batched prefill** (``chunked_prefill=False``, deprecated as in the
reference, which warns).  Each round's admissions are prefilled before
its decode chunk, by the dense ``forward`` (the flash kernel on the
card) over right-padded rows, whose K/V rows ``write_prefill_batch_to_
pages`` scatters into the pool; the first token is sampled from each
prompt's last row.  Dispatches are keyed by (padded length, group
size): with ``batch_prefill`` (the default) admissions of one padded
length share a dispatch, without it each takes its own.  Prefix-cache
hits prefill only their unmatched suffix through
``decode_step_paged_multi``, after the copy-on-write of a mid-page
match; best-of-N siblings (the same source pages) share one suffix
dispatch.  A model draft's pool gets the same rows.

Not ported, and refused with ``NotImplementedError``: ``mesh``.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.tokenizer import EOS, PAD
from repro_torch.metrics.runtime_metrics import (LagHistogram,
                                                 collect_serve_stats)
from repro_torch.models.registry import ModelBundle
from repro_torch.models.transformer import (copy_page_rows,
                                            paged_arch_unsupported, tree_to,
                                            write_prefill_batch_to_pages)
from repro_torch.obs.perfetto import trace_annotation
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER, Tracer
from repro_torch.resilience import NULL_INJECTOR, FaultInjector
from repro_torch.rollout.sampler import (accept_noise, gumbel_noise, sample,
                                        speculative_accept)
from repro_torch.serve.paged_cache import (RECLAIMED, PrefixKey,
                                           make_allocator, prefix_key)
from repro_torch.serve.scheduler import (ContinuousBatchingScheduler,
                                         Request, RequestState)
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
    prefill_dispatches: int = 0  # varlen rounds that carried prefill
    #                              tiles; batched: prefill dispatches
    finished: int = 0
    tokens_out: int = 0
    preemptions: int = 0
    swaps: int = 0
    occupancy_sum: float = 0.0   # emitting slots summed over decode steps
    # Speculation: drafted = k per active slot per round; accepted
    # counts draft tokens the verifier kept (corrections are not).
    spec_rounds: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    prefill_tokens: int = 0      # KV rows computed by prefill tiles
    cow_copies: int = 0          # prefix cache: copy-on-write page copies
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


class ModelDraft:
    """A draft policy with its own paged pool (self-speculation, fixed
    params or a separate model).  ``version`` is the store version the
    params are pinned at (None for fixed params); ``version_offset``
    not None marks self-speculation, re-pinned at ``latest + offset``
    after every verifier swap.  The pool shares the verifier's page ids
    and tables but holds this draft's own K/V rows."""

    def __init__(self, bundle: ModelBundle, params: Any,
                 version: Optional[int], version_offset: Optional[int],
                 num_blocks: int, block_size: int,
                 device: torch.device) -> None:
        reason = paged_arch_unsupported(bundle.cfg)
        if bundle.decode_step_paged is None or reason is not None:
            raise ValueError(
                f"draft arch {bundle.cfg.name} cannot run the paged path: "
                f"{reason}")
        self.bundle = bundle
        self.params = params
        self.version = version
        self.version_offset = version_offset
        self.pages = bundle.init_paged_cache(num_blocks, block_size,
                                             device=device)


class CallableDraft:
    """Host-side draft: ``fn(request, k) -> up to k int32 token ids``,
    treated as a one-hot draft distribution (which keeps the accept rule
    exact)."""

    version: Optional[int] = None
    version_offset = None

    def __init__(self, fn: Callable[[Request, int], Any]) -> None:
        self.fn = fn


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
        draft: Any = None,
        batch_prefill: bool = True,
        chunked_prefill: bool = True,
        prefill_chunk: int = 16,
        dispatch_budget: int = 32,
        mesh: Any = None,
        speculate_adaptive: bool = False,
        prefix_cache: bool = False,
        window_reclaim: bool = True,
        tracer: Optional[Tracer] = None,
        metrics: Optional[MetricsRegistry] = None,
        annotate: bool = False,
        injector: Optional[FaultInjector] = None,
        request_deadline_s: Optional[float] = None,
        spec_disable_after: int = 8,
        device: Any = None,
    ) -> None:
        """Arguments follow the JAX ``ServeEngine``; ``device`` picks
        ``cuda`` (default) or ``cpu``.  ``store`` (a
        ``runtime.PolicyStore`` on that device) replaces ``params``: the
        engine starts from its newest version.  ``draft`` is one of
        ``("version", -n)`` (self-speculation from the store, pinned),
        ``("params", p)``, ``("model", bundle, params)``, a callable
        ``fn(request, k)``, or None (``("version", -1)`` over a store,
        else the verifier's own params).  ``annotate=True`` wraps each
        dispatch in ``torch.profiler.record_function``."""
        if mesh is not None:
            raise NotImplementedError("ServeEngine: mesh is not ported yet")
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
        self.prefix_cache = bool(prefix_cache)
        self.allocator = make_allocator(num_blocks, block_size, 1,
                                        prefix_cache=self.prefix_cache,
                                        tracer=self.tracer)
        windows = [bundle.cfg.window_for_layer(layer)
                   for layer in range(bundle.cfg.n_layers)]
        self._reclaim_window = (
            max(windows) if window_reclaim and windows
            and all(w is not None for w in windows) else None)
        self.scheduler = ContinuousBatchingScheduler(
            self.allocator, max_batch=max_batch,
            max_blocks_per_request=max_blocks_per_request,
            prefix_fn=self._prefix_key if self.prefix_cache else None,
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
        # Batched prefill stacks same-padded-length admissions into one
        # dispatch (keyed by padded length and group size).
        self.batch_prefill = bool(batch_prefill)
        self.chunked_prefill = bool(chunked_prefill)
        if not self.chunked_prefill:
            warnings.warn(
                "chunked_prefill=False: the batched-prefill serve path "
                "is deprecated and kept only for comparison; chunked "
                "ragged prefill is the default",
                DeprecationWarning, stacklevel=2)
        self.prefill_chunk = max(int(prefill_chunk), 1)
        self.dispatch_budget = max(int(dispatch_budget), 1)

        # -- speculative decode ----------------------------------------------
        self.speculate_k = max(int(speculate_k), 0)
        self.speculate_adaptive = (bool(speculate_adaptive)
                                   and self.speculate_k > 1)
        self.draft: Any = None
        self._draft_lag_hist = LagHistogram()
        self._chosen_k_hist = LagHistogram()
        # Per-slot acceptance EMA; optimistic start (1.0 = draft the full
        # k), reset whenever a slot is re-admitted.
        self._accept_ema = np.ones((max_batch,), np.float64)
        self._accept_ema_alpha = 0.3
        # After `spec_disable_after` rounds in a row where every drafted
        # token was rejected, speculation turns itself off (the output
        # is the verifier's either way).
        self.spec_disable_after = max(int(spec_disable_after), 1)
        self.spec_disabled = False
        self._all_reject_rounds = 0
        if self.speculate_k:
            if bundle.decode_step_paged_multi is None:
                raise ValueError(f"{bundle.cfg.name}: multi-token verify "
                                 "unavailable (paged path unsupported)")
            self.draft = self._build_draft(draft, num_blocks, block_size)

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
        d = self.draft
        if isinstance(d, ModelDraft) and d.version_offset is not None:
            # The draft keeps its pin (pinned_versions() is the JAX
            # engine's) but reads a private copy from now on.
            d.params, _ = self.store.snapshot(d.version)

    def set_version(self, version: int) -> None:
        """Generate from the store's ``version`` from the next dispatch
        on, holding it (and dropping the hold on the version before), or
        copying it into the private buffers.  The draft stays as it is,
        as when the JAX forced-lag producer sets ``engine.params``."""
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
        self._refresh_draft()

    # -- speculative draft slot ----------------------------------------------

    def _build_draft(self, spec: Any, num_blocks: int,
                     block_size: int) -> Any:
        if callable(spec):
            return CallableDraft(spec)
        if spec is None:
            spec = (("version", -1) if self.store is not None
                    else ("params", self.params))
        kind = spec[0]
        if kind == "version":
            if self.store is None:
                raise ValueError("draft=('version', n) needs a PolicyStore")
            offset = int(spec[1])
            if offset > 0:
                raise ValueError(f"draft version offset must be <= 0, "
                                 f"got {offset}")
            params, version = self.store.pin_lagged(offset)
            return ModelDraft(self.bundle, params, version, offset,
                              num_blocks, block_size, self.device)
        if kind == "params":
            return ModelDraft(self.bundle, tree_to(spec[1], self.device),
                              None, None, num_blocks, block_size,
                              self.device)
        if kind == "model":
            return ModelDraft(spec[1], tree_to(spec[2], self.device), None,
                              None, num_blocks, block_size, self.device)
        raise ValueError(f"unknown draft spec {spec!r}")

    def _refresh_draft(self) -> None:
        """Re-pin the self-speculation draft at ``latest + offset`` after
        a verifier swap: pin the new version, then release the old one
        (one lock hold resolves and pins).  Draft pool rows written
        under the old weights stay; they only shape proposals.  With
        private weights the new version is copied into the draft's own
        buffers."""
        d = self.draft
        if not isinstance(d, ModelDraft) or d.version_offset is None:
            return
        params, target = self.store.pin_lagged(d.version_offset)
        if target == d.version:
            self.store.release(target)   # unchanged; drop the extra pin
            return
        self.store.release(d.version)
        if self._private:
            self.store.snapshot(target, out=d.params)
        else:
            d.params = params
        d.version = target

    # -- prefix cache ---------------------------------------------------------

    def _prefix_key(self, req: Request) -> PrefixKey:
        """Version-salted content address of ``req``'s committed ids (the
        JAX engine's salt, character for character), cached per
        (version, length)."""
        ids = self._committed_ids(req)
        cached = getattr(req, "_pkey", None)
        if cached is not None and cached[0] == (self.version, len(ids)):
            return cached[1]
        cfg = self.bundle.cfg
        salt = (
            f"{cfg.name}|{cfg.arch_type}|L{cfg.n_layers}|d{cfg.d_model}"
            f"|h{cfg.n_heads}x{cfg.n_kv_heads}|w{cfg.sliding_window}"
            f"/{cfg.global_every}|v{self.version}|bs{self.block_size}"
        ).encode()
        key = prefix_key(ids, self.block_size, salt)
        req._pkey = ((self.version, len(ids)), key)
        return key

    def _copy_on_write(self, reqs: List[Request]) -> None:
        """Copy each request's matched rows of its ``cow_src`` page into
        its own page, in both pools, then drop the source reference the
        scheduler reserved."""
        src = np.asarray([r.cow_src[0] for r in reqs], np.int64)
        rows = np.asarray([r.cow_src[1] for r in reqs], np.int64)
        dst = np.asarray([r.blocks[r.num_shared_full] for r in reqs],
                         np.int64)
        copy_page_rows(self.pages, src, dst, rows)
        if isinstance(self.draft, ModelDraft):
            copy_page_rows(self.draft.pages, src, dst, rows)
        for r in reqs:
            self.allocator.release([r.cow_src[0]], r.shard or 0)
            r.cow_src = None
        self.stats.cow_copies += len(reqs)
        if self.tracer.enabled:
            self.tracer.instant("cow_copy", tid="engine", n=len(reqs))

    def _assert_write_pages_private(self) -> None:
        """The page a slot's next decode write lands in must be owned by
        it alone (refcount 1).  Mid-prefill requests are skipped (a
        gated later admission may already share their incomplete pages),
        and a deferred copy-on-write reservation may hold a write page
        above 1 until the dependent's first tile copies it."""
        cow_pending: Dict[Tuple[int, int], int] = {}
        for r in self.scheduler.running:
            if r.cow_src is not None:
                k = ((r.shard or 0), r.cow_src[0])
                cow_pending[k] = cow_pending.get(k, 0) + 1
        for req in self.scheduler.running:
            if not req.prefill_done:
                continue
            idx = int(self._pos[req.slot]) // self.block_size
            if idx >= len(req.blocks):
                continue
            page = req.blocks[idx]
            if page >= 0:
                refs = self.allocator.ref(page, req.shard or 0)
                expect = 1 + cow_pending.get(((req.shard or 0), page), 0)
                if refs != expect:
                    raise RuntimeError(
                        f"request {req.request_id}: decode write page "
                        f"{page} has refcount {refs} (expected {expect})"
                        f" — copy-on-write invariant violated")

    # -- internals -----------------------------------------------------------

    def _to_dev(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the engine's device (never a view
        of the engine's mutable host state)."""
        return torch.tensor(arr, device=self.device)

    def _sample(self, logits: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        noise = gumbel_noise(logits.shape, self._gen, logits.device)
        return sample(logits, self._temperature, self._top_p, noise)

    def _accept_noise(self, b: int, k: int, v: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The verify pass's draws: ``u`` [B, k] and the correction's
        Gumbel noise [B, V]."""
        return accept_noise(b, k, v, self._gen, self.device)

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
        return self._host_sample(logits)

    def _draft_varlen(self, tokens: np.ndarray, row_start: np.ndarray,
                      row_len: np.ndarray, cap: np.ndarray) -> None:
        """A varlen round's rows written into the draft pool; no logits
        are read and no draw is made."""
        d = self.draft
        _, d.pages = d.bundle.decode_step_paged_varlen(
            d.params, self._to_dev(tokens), d.pages,
            self._to_dev(self._tables), self._to_dev(row_start),
            self._to_dev(row_len), self._to_dev(cap))

    def _chunked_round(self, finished: List[ServedTrajectory]) -> bool:
        """One unified varlen round, or False when no prefill is pending.

        Every decode-eligible slot's single-token row is reserved out of
        ``dispatch_budget`` first; the remainder goes to prefill tiles of
        at most ``prefill_chunk`` rows, FIFO by admission order, with a
        one-row floor for the oldest ready tile so admission always
        progresses.  With the prefix cache a tile starts after its
        matched rows, and a model draft's pool gets the same rows.
        """
        pending = [r for r in self.scheduler.running if not r.prefill_done]
        if not pending:
            return False
        tr = self.tracer
        bs = self.block_size
        # Prefix-cache gate: pages whose rows an in-flight prefill has
        # not computed yet, keyed to their computing owner; a pending
        # request that shares (or copies from) such a page of another
        # request waits until its rows land.  A dependency always points
        # at an earlier admission, so the oldest pending one never waits.
        incomplete: Dict[Tuple[int, int], Request] = {}
        for r in pending:
            sh = r.shard or 0
            for j, b in enumerate(r.blocks):
                if b != RECLAIMED and (j + 1) * bs > r.num_prefilled:
                    incomplete[(sh, b)] = r

        def _gated(r: Request) -> bool:
            sh = r.shard or 0
            deps = list(r.blocks[:r.num_shared_full])
            if r.cow_src is not None:
                deps.append(r.cow_src[0])
            return any(incomplete.get((sh, b)) not in (None, r)
                       for b in deps)

        order = {id(r): i for i, r in
                 enumerate(self.scheduler._admission_order)}
        ready = sorted((r for r in pending if not _gated(r)),
                       key=lambda r: order[id(r)])
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
        # Deferred copy-on-write: a mid-page match is copied into the
        # request's own page right before its first tile (the copy
        # clears cow_src); the tile then attends over the copied rows.
        cow_reqs = [r for r, _, _ in chunks if r.cow_src is not None]
        if cow_reqs:
            self._copy_on_write(cow_reqs)
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
            if isinstance(self.draft, ModelDraft):
                # The same rows into the draft pool, under the draft's
                # weights: later speculative rounds read them as context.
                self._draft_varlen(tokens, row_start, row_len, cap)
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

    # -- batched prefill (chunked_prefill=False) ------------------------------

    def _prefill_admitted(self, admitted: List[Request],
                          finished: List[ServedTrajectory]) -> None:
        """(Re)compute the KV rows of every admitted request; admissions
        of one padded length share a dispatch with ``batch_prefill``.
        Prefix-cache hits take the suffix path (their matched rows are
        resident in shared pages).  Dense prefills go first, suffix
        prefills follow in admission order: an admission can match only
        pages of earlier admissions, so every page a suffix dispatch
        reads was written by an earlier dispatch."""
        if not admitted:
            return
        dense: List = []
        shared: List = []
        for req in admitted:
            ids = self._committed_ids(req)
            item = (req, ids, int(ids.shape[0]))
            (shared if req.num_matched > 0 else dense).append(item)
        groups: Dict[int, List] = {}
        for item in dense:
            padded = -(-item[2] // self.block_size) * self.block_size
            groups.setdefault(padded, []).append(item)
        for padded in sorted(groups):
            items = groups[padded]
            size = len(items) if self.batch_prefill else 1
            for lo in range(0, len(items), size):
                self._prefill_group(padded, items[lo:lo + size], finished)
        # Only runs of requests sharing exactly the same source pages
        # (best-of-N siblings) batch into one suffix dispatch: they
        # cannot depend on each other's writes.
        i = 0
        while i < len(shared):
            j = i + 1
            if self.batch_prefill:
                while j < len(shared) and self._suffix_compatible(
                        shared[i], shared[j]):
                    j += 1
            self._suffix_group(shared[i:j], finished)
            i = j

    @staticmethod
    def _suffix_compatible(a, b) -> bool:
        ra, _, pa = a
        rb, _, pb = b
        nsf = ra.num_shared_full
        return (pa == pb and ra.num_matched == rb.num_matched
                and ra.shard == rb.shard and nsf == rb.num_shared_full
                and ra.blocks[:nsf] == rb.blocks[:nsf]
                and ra.cow_src == rb.cow_src)

    def _land_prefill(self, items: List, tables: np.ndarray,
                      toks: np.ndarray, lps: np.ndarray,
                      finished: List[ServedTrajectory]) -> None:
        """Slot state after a prefill dispatch; each request's sampled
        token is its first emission, unless it resumes after preemption
        (its pending token was recorded before)."""
        for i, (req, _, plen) in enumerate(items):
            slot = req.slot
            self._tables[slot] = tables[i]
            self._pos[slot] = plen
            req.num_prefilled = plen
            if req.tokens:
                self._last_tok[slot] = req.tokens[-1]
            else:
                self._record(req, int(toks[i]), float(lps[i]), finished)

    def _host_sample(self, logits: torch.Tensor
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """One draw from ``logits`` [N, V]; host (tokens, log_beta) after
        one device-to-host copy."""
        tok, lp = self._sample(logits)
        both = torch.stack([tok.double(), lp.double()]).cpu().numpy()
        return both[0].astype(np.int32), both[1].astype(np.float32)

    def _suffix_group(self, items: List,
                      finished: List[ServedTrajectory]) -> None:
        """Copy-on-write, then a suffix-only prefill for one compatible
        group: the ``t`` unmatched tokens through the multi-token paged
        step (writing their rows, attending over the shared prefix),
        sampling from the last one."""
        n = len(items)
        req0, _, plen0 = items[0]
        m = req0.num_matched
        t = plen0 - m
        t_pad = -(-t // 4) * 4             # the JAX engine's padding
        width = self._tables.shape[1]
        toks = np.full((n, t_pad), PAD, np.int32)
        tables = np.zeros((n, width), np.int32)
        cap = np.zeros((n,), np.int32)
        for i, (req, ids, plen) in enumerate(items):
            toks[i, :t] = ids[m:]
            tables[i] = self.allocator.padded_table(req.blocks, width)
            cap[i] = plen
        if req0.cow_src is not None:
            # The match ends mid-page: its rows go into each request's
            # own page (the table already points there) in both pools.
            self._copy_on_write([req for req, _, _ in items])
        pos = np.full((n,), m, np.int32)
        with self.tracer.span("suffix_prefill", tid="engine", n=n,
                              suffix=t), \
                self._ann("serve.suffix_prefill"):
            tok_np, lp_np = self._suffix(toks, tables, pos, cap, t - 1)
        self.stats.prefills += n
        self.stats.prefill_dispatches += 1
        self.stats.prefill_tokens += n * t
        if isinstance(self.draft, ModelDraft):
            self._suffix_pool(self.draft.bundle, self.draft.params,
                              self.draft.pages, toks, tables, pos, cap)
        self._land_prefill(items, tables, tok_np, lp_np, finished)

    @torch.no_grad()
    def _suffix_pool(self, bundle: ModelBundle, params: Any, pages: Dict,
                     toks: np.ndarray, tables: np.ndarray, pos: np.ndarray,
                     cap: np.ndarray) -> torch.Tensor:
        """The suffix rows ``toks`` [N, T] from ``pos`` through the
        multi-token paged step into ``pages`` (rows below ``cap``);
        returns the logits [N, T, V]."""
        ones = torch.ones((toks.shape[0],), dtype=torch.bool,
                          device=self.device)
        out, _ = bundle.decode_step_paged_multi(
            params, self._to_dev(toks), pages, self._to_dev(tables),
            self._to_dev(pos), ones, self._to_dev(cap))
        return out.logits

    def _suffix(self, toks: np.ndarray, tables: np.ndarray, pos: np.ndarray,
                cap: np.ndarray, tlast: int
                ) -> Tuple[np.ndarray, np.ndarray]:
        """One suffix prefill dispatch under the served params; host
        (tokens, log_beta) sampled from row ``tlast``."""
        logits = self._suffix_pool(self.bundle, self.params, self.pages,
                                   toks, tables, pos, cap)
        return self._host_sample(logits[:, tlast])

    def _prefill_group(self, padded: int, items: List,
                       finished: List[ServedTrajectory]) -> None:
        """One batched prefill dispatch over ``items``' right-padded
        prompts (``padded`` rows each)."""
        n = len(items)
        width = self._tables.shape[1]
        rows = np.zeros((n, padded), np.int32)
        kv_valid = np.zeros((n, padded), bool)
        plens = np.zeros((n,), np.int32)
        tables = np.zeros((n, width), np.int32)
        for i, (req, ids, plen) in enumerate(items):
            rows[i, :plen] = ids
            kv_valid[i, :plen] = True
            plens[i] = plen
            tables[i] = self.allocator.padded_table(req.blocks, width)
        with self.tracer.span("prefill", tid="engine", n=n,
                              padded=padded), \
                self._ann("serve.prefill"):
            toks_np, lps_np = self._prefill(rows, kv_valid, tables, plens)
        self.stats.prefills += n
        self.stats.prefill_dispatches += 1
        self.stats.prefill_tokens += int(plens.sum())
        if isinstance(self.draft, ModelDraft):
            self._prefill_pool(self.draft.bundle, self.draft.params,
                               self.draft.pages, rows, kv_valid, tables,
                               plens)
        self._land_prefill(items, tables, toks_np, lps_np, finished)

    @torch.no_grad()
    def _prefill_pool(self, bundle: ModelBundle, params: Any, pages: Dict,
                      rows: np.ndarray, kv_valid: np.ndarray,
                      tables: np.ndarray, plens: np.ndarray) -> torch.Tensor:
        """The dense forward over ``rows`` [N, P] with their padding mask,
        its K/V rows written into ``pages`` (rows below each prompt's
        length); returns each prompt's last-row logits [N, V]."""
        out = bundle.forward(params, self._to_dev(rows), return_cache=True,
                             cache_len=rows.shape[1],
                             kv_valid=self._to_dev(kv_valid))
        write_prefill_batch_to_pages(out.cache["k"], out.cache["v"], pages,
                                     tables, plens)
        last = torch.as_tensor(plens.astype(np.int64) - 1,
                               device=self.device)
        return out.logits[torch.arange(rows.shape[0], device=self.device),
                          last]

    def _prefill(self, rows: np.ndarray, kv_valid: np.ndarray,
                 tables: np.ndarray, plens: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched prefill dispatch under the served params; host
        (tokens, log_beta) of each prompt's first emission."""
        logits = self._prefill_pool(self.bundle, self.params, self.pages,
                                    rows, kv_valid, tables, plens)
        return self._host_sample(logits)

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
        """One scheduling round + decode chunk (or varlen round; without
        chunked prefill, the admissions' prefill dispatches first);
        returns newly finished trajectories."""
        finished: List[ServedTrajectory] = []
        tr = self.tracer
        self._maybe_swap()
        self.stats.steps += 1
        if self.injector.active:
            # Straggler injection: a matching stall sleeps here, with the
            # deadline clock running, which is how a hung slot turns into
            # a timeout retirement.
            self.injector.stall("engine_step", at_step=self.stats.steps)
            for req in self.scheduler.running:
                self.injector.stall("engine_step", at_step=self.stats.steps,
                                    slot=int(req.slot))
        # Deadline sweep before scheduling: expired waiting requests are
        # never admitted, expired running ones free their slot and pages.
        for req in self.scheduler.expire():
            self._timeout_finish(req, finished)
        lookahead = self._spec_k_active or self.decode_chunk
        with tr.span("schedule", tid="engine"):
            admitted, _ = self.scheduler.schedule(lookahead=lookahead)
        self.stats.preemptions = self.scheduler.preemptions
        if admitted:
            now = time.monotonic()
            for req in admitted:
                self._h_queue_wait.observe(now - req.queued_time)
                req.admit_time = now
        for req in admitted:
            # A fresh occupant: the previous one's acceptance EMA says
            # nothing about it.
            self._accept_ema[req.slot] = 1.0
        if self.chunked_prefill:
            # Admissions stream in as ragged tiles over the next rounds:
            # mark them pending and park the write cursor at the first row.
            for req in admitted:
                req.prefill_done = False
                self._pos[req.slot] = req.num_prefilled
        else:
            self._prefill_admitted(admitted, finished)
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
        if self.prefix_cache:
            self._assert_write_pages_private()
        if tr.enabled:
            sched = self.scheduler
            tr.counter("serve_load", waiting=float(len(sched.waiting)),
                       running=float(len(sched.running)))
            tr.counter("pool_free", free=float(self.allocator.num_free))
            if self.store is not None:
                tr.counter("policy_lag",
                           lag=float(self.store.version - self.version))
        if self.chunked_prefill and self._chunked_round(finished):
            return finished
        if not self._active.any():
            return finished
        if self._spec_k_active:
            with tr.span("spec_round", tid="engine"):
                self._spec_round(finished)
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

    # -- speculative rounds --------------------------------------------------

    @property
    def _spec_k_active(self) -> int:
        """Speculation depth for this round: 0 once auto-disabled."""
        return 0 if self.spec_disabled else self.speculate_k

    def _choose_k(self) -> int:
        """This round's draft length: ``speculate_k``, or with
        ``speculate_adaptive`` the mean over active slots of ``1 +
        round(ema * (k_max - 1))``."""
        k_max = self.speculate_k
        if not self.speculate_adaptive:
            return k_max
        act = self._active
        if not act.any():
            return k_max
        targets = np.clip(
            np.rint(1.0 + self._accept_ema[act] * (k_max - 1)), 1, k_max)
        return int(np.clip(np.rint(targets.mean()), 1, k_max))

    def _note_spec_round(self, accepted: int, n_active: int) -> None:
        """Count all-reject rounds in a row; turn speculation off once
        ``spec_disable_after`` of them land."""
        if n_active <= 0:
            return
        if accepted > 0:
            self._all_reject_rounds = 0
            return
        self._all_reject_rounds += 1
        if (self._all_reject_rounds >= self.spec_disable_after
                and not self.spec_disabled):
            self.spec_disabled = True
            self.stats.spec_autodisables += 1
            self.metrics.counter("spec_autodisable_total").inc()
            if self.tracer.enabled:
                self.tracer.instant(
                    "spec_autodisable", tid="engine",
                    rounds=self._all_reject_rounds, k=self.speculate_k)

    def _draft(self, k: int, cap: np.ndarray
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``k`` draft decode steps over the draft pool: ``(tokens [B,
        k], logits [B, k, V])``.  A step past a slot's pages (``pos >=
        cap``) goes inactive: it writes nothing and proposes PAD.  One
        sampling draw a step; no host sync."""
        d = self.draft
        token = self._to_dev(self._last_tok)
        tables = self._to_dev(self._tables)
        pos = self._to_dev(self._pos)
        active = self._to_dev(self._active)
        cap_d = self._to_dev(cap)
        pad = torch.full_like(token, PAD)
        toks, logits = [], []
        for _ in range(k):
            step_active = active & (pos < cap_d)
            out, d.pages = d.bundle.decode_step_paged(
                d.params, token, d.pages, tables, pos, step_active)
            tok, _ = self._sample(out.logits)
            token = torch.where(step_active, tok, pad)
            toks.append(token)
            logits.append(out.logits)
            pos = pos + 1
        return torch.stack(toks, dim=1), torch.stack(logits, dim=1)

    def _verify(self, k: int, draft_toks: torch.Tensor,
                draft_logits: torch.Tensor, cap: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """One multi-token verify pass over queries ``[t0, d1 .. d_{k-1}]``
        (all ``k`` rows written below ``cap``; a rejection only rewinds
        ``pos``), then the accept rule.  Returns host ``(tokens [B, k],
        log_p [B, k], n_accepted [B], n_emitted [B])`` after one
        device-to-host copy; inactive slots give PAD, 0, 0, 0."""
        first = self._to_dev(self._last_tok)
        active = self._to_dev(self._active)
        queries = torch.cat([first[:, None], draft_toks[:, :-1]], dim=1)
        out, self.pages = self.bundle.decode_step_paged_multi(
            self.params, queries, self.pages, self._to_dev(self._tables),
            self._to_dev(self._pos), active, self._to_dev(cap))
        b, _, v = out.logits.shape
        u, g = self._accept_noise(b, k, v)
        toks, lps, n_acc, n_emit = speculative_accept(
            out.logits, draft_toks, draft_logits, u, g,
            temperature=self._temperature, top_p=self._top_p)
        toks = torch.where(active[:, None], toks, torch.full_like(toks, PAD))
        lps = torch.where(active[:, None], lps, torch.zeros_like(lps))
        zero = torch.zeros_like(n_acc)
        n_acc = torch.where(active, n_acc, zero)
        n_emit = torch.where(active, n_emit, zero)
        host = torch.cat([toks.double(), lps.double(),
                          n_acc[:, None].double(), n_emit[:, None].double()],
                         dim=1).cpu().numpy()
        return (host[:, :k].astype(np.int32), host[:, k:2 * k].astype(
            np.float32), host[:, 2 * k].astype(np.int64),
            host[:, 2 * k + 1].astype(np.int64))

    def _callable_proposals(self, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A host draft's proposals and their one-hot logits (0 at the
        proposal, -1e9 elsewhere)."""
        prop_np = np.zeros((self.max_batch, k), np.int32)
        for req in self.scheduler.running:
            prop = np.asarray(self.draft.fn(req, k), np.int32).reshape(-1)[:k]
            prop_np[req.slot, :prop.shape[0]] = prop
        prop = self._to_dev(prop_np)
        oh = torch.full((self.max_batch, k, self.bundle.cfg.vocab_size),
                        -1e9, dtype=torch.float32, device=self.device)
        oh.scatter_(-1, prop.long()[..., None], 0.0)
        return prop, oh

    def _spec_round(self, finished: List[ServedTrajectory]) -> None:
        """One draft-then-verify round: ``k`` draft steps (or a host
        proposal), one verify pass, accept / rollback by ``pos``
        rewind."""
        tr = self.tracer
        k = self._choose_k()
        self._chosen_k_hist.record(k)
        cap = np.zeros((self.max_batch,), np.int32)
        for req in self.scheduler.running:
            cap[req.slot] = len(req.blocks) * self.block_size
        if isinstance(self.draft, ModelDraft):
            with tr.span("draft", tid="engine", k=k), \
                    self._ann("serve.draft"):
                draft_toks, draft_logits = self._draft(k, cap)
        else:
            draft_toks, draft_logits = self._callable_proposals(k)
        with tr.span("verify", tid="engine", k=k), \
                self._ann("serve.verify"):
            toks_np, lps_np, n_acc_np, n_emit_np = self._verify(
                k, draft_toks, draft_logits, cap)
        n_active = int(self._active.sum())
        self.stats.decode_steps += 1
        self.stats.occupancy_sum += float(n_active)
        self.stats.spec_rounds += 1
        self.stats.drafted_tokens += k * n_active
        accepted = int(n_acc_np[self._active].sum())
        self.stats.accepted_tokens += accepted
        self._note_spec_round(accepted, n_active)
        if tr.enabled:
            rejected = k * n_active - accepted
            if rejected:
                tr.instant("rollback", tid="engine", k=k, rejected=rejected)
        if self.speculate_adaptive:
            a = self._accept_ema_alpha
            for slot in np.nonzero(self._active)[0]:
                rate = float(n_acc_np[slot]) / k
                self._accept_ema[slot] = (
                    (1.0 - a) * self._accept_ema[slot] + a * rate)
        lag = (None if self.draft.version is None
               else self.version - self.draft.version)
        for req in list(self.scheduler.running):
            slot = req.slot
            n_e = int(n_emit_np[slot])
            # Rollback is a rewind: pos covers the emitted prefix only,
            # and the next round overwrites the rejected rows.
            self._pos[slot] += n_e
            if lag is not None and n_e:
                self._draft_lag_hist.record(lag, n_e)
            for t in range(n_e):
                self._record(req, int(toks_np[slot, t]),
                             float(lps_np[slot, t]), finished)
                if req.state is not RequestState.RUNNING:
                    break    # EOS or the budget retired it; drop the tail

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
