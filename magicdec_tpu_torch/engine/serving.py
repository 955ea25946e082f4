"""Continuous-batching speculative serving (counterpart of
magicdec_tpu/engine/serving.py ``ServingEngine`` and
``PagedServingEngine``).

A stream of requests is served through B batch slots.  Each admission wave
prefills its queued prompts (one encode per equal-length bucket) and splices
them into free slots; every speculation window runs the fixed-batch
engine's own window over all B slots with ``masks=(active, done)``, so
acceptance and termination are per request and slots that are not live are
frozen; a finished request is drained and its slot recycled.  The host
reads the batch once per ``windows_per_sync`` windows (the JAX package scans
those windows in one program; here they run as a Python loop with no host
read inside it).  Admission and drain go through the FCFS ``Scheduler`` and
the KV ``PageAllocator`` of ``magicdec_tpu_torch/native.py``.

``ServingEngine`` gives every slot a contiguous ``[S, K]`` cache region, so
its capacity is B x max_seq_len.  ``PagedServingEngine`` keeps the target
cache in a shared page pool read through per-slot page tables (the paged
decode and append kernels, ``kernels/paged_attention.py``), so its capacity
is the sum of the admitted requests' lengths.  ``ServingLongSpecEngine``
and ``PagedServingLongSpecEngine`` serve with a standalone draft model
(``LongSpecEngine``'s encode and window; its draft cache stays contiguous a
slot, as in the JAX package).  Greedy, or sampled under
``EngineConfig.temperature`` > 0: one stream key for the batch
(``serve(..., rng=...)``) and each request's id as its noise-stream salt,
spliced into its slot at admission, so a request samples the tokens it
would sample alone with that salt.  A data axis of page groups is ROADMAP
item A15.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from magicdec_tpu_torch import native
from magicdec_tpu_torch.engine.engine import LongSpecEngine, SpecEngine
from magicdec_tpu_torch.engine.state import ServingState, SpecState
from magicdec_tpu_torch.ops import paged_kv as PKV

# the per-slot carries an admission splices from the encoded wave
_SLOT_FIELDS = ("target_lens", "draft_fill", "draft_pos", "token0", "num_committed",
                "output", "db_tokens", "db_update")


class ServingEngine(SpecEngine):
    """Self-speculation (either draft cache) with a per-request lifecycle
    over B contiguous slots.  ``serve(prompts, B)`` runs the whole stream and
    returns each request's generated tokens in submission order."""

    def _empty_state(self, tcaches: dict, dcaches: dict, B: int, table=None,
                     rng=None) -> ServingState:
        def z(n):
            return torch.zeros((n,), dtype=torch.int32, device=self.device)

        spec = SpecState(
            k=tcaches["k"], v=tcaches["v"], ks=tcaches.get("ks"), vs=tcaches.get("vs"),
            table=table, target_lens=z(B), dk=dcaches["dk"], dv=dcaches["dv"],
            draft_fill=z(B), draft_pos=z(B), token0=z(B),
            output=torch.zeros((B, self._out_cap), dtype=torch.int32, device=self.device),
            num_committed=z(B),
            target_steps=torch.zeros((), dtype=torch.int32, device=self.device),
            done=torch.zeros((), dtype=torch.bool, device=self.device),
            db_tokens=torch.zeros((B, 2), dtype=torch.int32, device=self.device),
            db_update=torch.ones((B,), dtype=torch.int32, device=self.device),
            rng=rng, salt=None if rng is None else z(B))
        flags = torch.zeros((B,), dtype=torch.bool, device=self.device)
        return ServingState(spec=spec, active=flags, done=flags.clone())

    def init_serving(self, B: int, total_pages: Optional[int] = None,
                     rng=None) -> ServingState:
        """An empty batch of B slots (``total_pages`` sizes the page pool of
        ``PagedServingEngine``; contiguous slots have none).  Under sampling
        ``rng`` is the batch's stream key; the salts come with admission."""
        rng, _ = self._sampling_args(B, rng, None)
        tcaches, dcaches = self._zero_caches(B)
        return self._empty_state(tcaches, dcaches, B, rng=rng)

    # -- admission ----------------------------------------------------------

    def admit_many(self, sst: ServingState, admissions) -> ServingState:
        """Admit a wave: ``admissions`` = [(slot, prompt, request id), ...].
        Prompts are bucketed by length; each bucket prefills as ONE encode
        over its [k, P] prompts and is spliced into its slots.  The request
        id is the request's noise-stream salt under sampling.
        ``PagedServingEngine`` takes a fourth entry, the slot's table row
        [npr] int32: its pool pages (allocator pages offset past the scratch
        pages; unused tail entries = the slot's scratch page)."""
        buckets: Dict[int, list] = {}
        for adm in admissions:
            buckets.setdefault(len(adm[1]), []).append(adm)
        for group in buckets.values():
            slots = torch.as_tensor([g[0] for g in group], dtype=torch.long,
                                    device=self.device)
            stk = self.encode(np.stack([np.asarray(g[1]) for g in group]),
                              rng=sst.spec.rng, salt=[g[2] for g in group])
            sst = self._admit(sst, stk, slots, group)
        return sst

    def _splice(self, sst: ServingState, stk: SpecState, slots, **spec_upd) -> ServingState:
        """The draft caches and per-slot carries of the encoded wave into
        ``slots`` (caches in place); the slots become live."""
        spec = sst.spec
        spec.dk.index_copy_(1, slots, stk.dk)
        spec.dv.index_copy_(1, slots, stk.dv)
        upd = {n: getattr(spec, n).index_copy(0, slots, getattr(stk, n)) for n in _SLOT_FIELDS}
        if spec.salt is not None:
            upd["salt"] = spec.salt.index_copy(0, slots, stk.salt)
        return ServingState(spec=dataclasses.replace(spec, **upd, **spec_upd),
                            active=sst.active.index_fill(0, slots, True),
                            done=sst.done.index_fill(0, slots, False))

    def _admit(self, sst: ServingState, stk: SpecState, slots, group) -> ServingState:
        spec = sst.spec
        for n in ("k", "v", "ks", "vs"):
            if getattr(spec, n) is not None:
                getattr(spec, n).index_copy_(1, slots, getattr(stk, n))
        return self._splice(sst, stk, slots)

    # -- the serving loop ---------------------------------------------------

    def _serve_pages(self):
        """(page size, pages per slot) of the allocator's accounting: the
        contiguous slots own whole cache rows, so pages of 128 rows only
        gate admission (``total_pages``), as in the JAX package."""
        return 128, -(-self.ecfg.max_seq_len // 128)

    def _admission(self, slot: int, prompt, rid: int, alloc, aslot: int):
        return (slot, prompt, rid)

    def _drain(self, sst: ServingState, idx: torch.Tensor) -> ServingState:
        return ServingState(spec=sst.spec, active=sst.active.index_fill(0, idx, False),
                            done=sst.done.index_fill(0, idx, False))

    def serve(self, prompts: List[np.ndarray], B: int, windows_per_sync: int = 4,
              total_pages: Optional[int] = None, rng=None) -> List[np.ndarray]:
        """Serve every prompt (arbitrary lengths) through B slots; returns
        each request's generated tokens in submission order.  ``rng``: the
        stream key under sampling (each request samples with its id as the
        salt).

        Each admission reserves ceil((prompt + max_gen + gamma + 2) / page
        size) pages and releases them at drain; with ``total_pages`` below
        the full B-slot capacity, admission blocks FCFS until pages free
        (backpressure).  Per-request queue and service latencies, admission
        waves, the refills where a free slot waited for pages
        (``page_blocked``), the windows run and tokens per target pass land
        in ``self.last_serve_stats``."""
        e = self.ecfg
        ps, cap = self._serve_pages()
        reserve = e.max_gen + e.gamma + 2
        n_pages = B * cap if total_pages is None else total_pages
        worst = -(-(max(len(p) for p in prompts) + reserve) // ps)
        if n_pages < worst:
            raise ValueError(f"total_pages={n_pages} cannot hold the longest request "
                             f"({worst} pages)")
        sst = self.init_serving(B, total_pages=n_pages, rng=rng)
        sched = native.Scheduler(B)
        alloc = native.PageAllocator(n_pages, ps, B, cap)
        slot_pages: Dict[int, int] = {}  # batch slot -> allocator slot
        pending = deque(range(len(prompts)))
        t0 = time.perf_counter_ns()

        def now_us():
            return (time.perf_counter_ns() - t0) // 1000

        for rid in range(len(prompts)):
            sched.submit(rid, now_us())
        results: Dict[int, np.ndarray] = {}
        passes_of: Dict[int, int] = {}
        # target passes each slot's request was live for (device; read at drain)
        passes = torch.zeros((B,), dtype=torch.int32, device=self.device)
        count = dict(waves=0, admitted=0, admit_s=0.0, min_free=alloc.free_pages(),
                     windows=0, page_blocked=0)

        def refill(sst):
            active, done = torch.stack([sst.active, sst.done]).cpu().numpy()
            drained = [s for s in range(B) if active[s] and done[s]]
            if drained:
                out, committed, npass = (t.cpu().numpy() for t in
                                         (sst.spec.output, sst.spec.num_committed, passes))
                for slot in drained:
                    rid = sched.complete(slot, now_us())
                    alloc.release(slot_pages.pop(slot))
                    results[rid] = out[slot, :int(committed[slot])]
                    passes_of[rid] = int(npass[slot])
                idx = torch.as_tensor(drained, dtype=torch.long, device=self.device)
                passes.index_fill_(0, idx, 0)
                sst = self._drain(sst, idx)
            wave = []
            while pending:
                need_len = len(prompts[pending[0]]) + reserve
                if alloc.free_pages() < -(-need_len // ps):
                    # FCFS backpressure: the head of the line waits for pages
                    count["page_blocked"] += sched.counts()[1] < B
                    break
                got = sched.assign(now_us(), max_n=1)
                if not got:
                    break  # no free slot
                rid, slot = got[0]
                assert rid == pending.popleft()
                aslot = alloc.admit(need_len)
                assert aslot >= 0
                slot_pages[slot] = aslot
                wave.append(self._admission(slot, prompts[rid], rid, alloc, aslot))
            count["min_free"] = min(count["min_free"], alloc.free_pages())
            if wave:
                t = time.perf_counter()
                sst = self.admit_many(sst, wave)
                count["admit_s"] += time.perf_counter() - t
                count["waves"] += 1
                count["admitted"] += len(wave)
            return sst

        sst = refill(sst)
        while pending or slot_pages:
            for _ in range(windows_per_sync):  # no host read in here
                passes += (sst.active & ~sst.done).to(torch.int32)
                spec, done = self._window()(sst.spec, masks=(sst.active, sst.done))
                sst = ServingState(spec=spec, active=sst.active, done=done)
            count["windows"] += windows_per_sync
            sst = refill(sst)
        mean_q_us, mean_s_us = sched.stats()
        gen = sum(len(results[i]) - 1 for i in results)
        self.last_serve_stats = {
            "mean_queue_ms": mean_q_us / 1e3, "mean_service_ms": mean_s_us / 1e3,
            "served": sched.counts()[2], "admission_waves": count["waves"],
            "mean_admissions_per_wave": count["admitted"] / max(count["waves"], 1),
            "admission_time_s": count["admit_s"], "total_pages": n_pages,
            "min_free_pages": count["min_free"], "windows": count["windows"],
            "page_blocked": count["page_blocked"],
            "request_passes": [passes_of[i] for i in range(len(prompts))],
            "tokens_per_step": gen / max(sum(passes_of.values()), 1)}
        return [results[i] for i in range(len(prompts))]


class PagedServingEngine(ServingEngine):
    """Continuous-batching serving over a shared KV page POOL.

    The target cache is a pool [L, P, page_size, Kc] (+ scale pools [L, P,
    Hkv, page_size] when quantized) and ``SpecState.table`` [B, npr] maps
    each slot's logical pages to pool pages, assigned by the PageAllocator
    at admission waves:

    - pool pages 0..B-1 are per-slot SCRATCH pages: a drained slot points its
      whole row of the table at its scratch page, and a live slot's unused
      tail entries do too, so the masked-out appends that slots which are
      not live still execute never land in pages of live requests;
    - admission prefills CONTIGUOUS (the wave's [k, S] caches are transient)
      and splices only the pages the allocator assigned;
    - the decode windows run the paged decode kernel (B12) and one paged
      append per forward (B13).

    The draft's budget-sized caches stay contiguous per slot (SnapKV's
    verify appends its draft half there by K3).  One page
    group only (the JAX package's data axis is ROADMAP item A15).
    """

    @property
    def _npr(self) -> int:
        e = self.ecfg
        if e.max_seq_len % e.page_size:
            raise ValueError(f"max_seq_len {e.max_seq_len} must be a multiple of page_size "
                             f"{e.page_size}")
        # the JAX package's rules (its paged append's 8-row blocks and the
        # 128-column scale blocks of its quantized pools), kept so that both
        # packages accept the same configurations
        if e.page_size % 8:
            raise ValueError(f"page_size {e.page_size} must be a multiple of 8")
        if e.page_size > 128 and e.page_size % 128:
            raise ValueError(f"page_size {e.page_size} > 128 must be a multiple of 128")
        return e.max_seq_len // e.page_size

    def init_serving(self, B: int, total_pages: Optional[int] = None,
                     rng=None) -> ServingState:
        """B empty slots over a pool of ``total_pages`` pages (default: the
        full B x npr capacity) plus the B scratch pages (``rng`` as in
        ``ServingEngine.init_serving``)."""
        rng, _ = self._sampling_args(B, rng, None)
        e, c = self.ecfg, self.cfg
        ps, npr = e.page_size, self._npr
        P = (B * npr if total_pages is None else total_pages) + B
        bits = self._kv_bits
        lane = c.n_kv_head * c.head_dim // (2 if bits == 4 else 1)
        dt = torch.int8 if bits else e.cache_dtype
        tcaches = {n: PKV.alloc_pool(c.n_layer, P, ps, lane, dt, self.device) for n in "kv"}
        if bits:
            tcaches.update({n: PKV.alloc_scale_pool(c.n_layer, P, c.n_kv_head, ps,
                                                    e.kv_scale_dtype, self.device)
                            for n in ("ks", "vs")})
        table = self._scratch_rows(torch.arange(B, device=self.device))
        return self._empty_state(tcaches, self._zero_draft_caches(B), B, table=table, rng=rng)

    def _scratch_rows(self, slots: torch.Tensor) -> torch.Tensor:
        """Table rows [k, npr] pointing every logical page of ``slots`` at
        their scratch pages."""
        return slots.to(torch.int32)[:, None].repeat(1, self._npr)

    def _admit(self, sst: ServingState, stk: SpecState, slots, group) -> ServingState:
        e = self.ecfg
        ps, npr = e.page_size, self._npr
        spec = sst.spec
        tables = torch.as_tensor(np.stack([np.asarray(g[3]) for g in group]),
                                 dtype=torch.int32, device=self.device)
        # splice only the pages the allocator assigned: the table's tail
        # entries alias the scratch page, and the wave's caches hold
        # nothing past the prompt and its generation budget
        n_used = -(-(len(group[0][1]) + e.max_gen + e.gamma + 2) // ps)
        flat = tables[:, :n_used].reshape(-1).long()

        def to_pages(c):  # [L, k, S, Kc] -> [L, k*n_used, ps, Kc]
            L, k, _, Kc = c.shape
            return c.reshape(L, k, npr, ps, Kc)[:, :, :n_used].reshape(L, k * n_used, ps, Kc)

        def to_scale_pages(s):  # [L, k, H, S] -> [L, k*n_used, H, ps]
            L, k, H, _ = s.shape
            return (s.reshape(L, k, H, npr, ps)[:, :, :, :n_used].permute(0, 1, 3, 2, 4)
                    .reshape(L, k * n_used, H, ps))

        spec.k.index_copy_(1, flat, to_pages(stk.k))
        spec.v.index_copy_(1, flat, to_pages(stk.v))
        if spec.ks is not None:
            spec.ks.index_copy_(1, flat, to_scale_pages(stk.ks))
            spec.vs.index_copy_(1, flat, to_scale_pages(stk.vs))
        return self._splice(sst, stk, slots, table=spec.table.index_copy(0, slots, tables))

    def _serve_pages(self):
        return self.ecfg.page_size, self._npr

    def _admission(self, slot: int, prompt, rid: int, alloc, aslot: int):
        B = alloc.shape[0]
        row = alloc.tables()[0][aslot].copy()
        row[row >= 0] += B       # pool pages 0..B-1 are the scratch pages
        row[row < 0] = slot      # the unused tail -> the slot's scratch page (never read)
        return (slot, prompt, rid, row.astype(np.int32))

    def _drain(self, sst: ServingState, idx: torch.Tensor) -> ServingState:
        """Drained slots point their whole table row at their scratch page
        before the allocator hands their pages to another request."""
        sst = super()._drain(sst, idx)
        table = sst.spec.table.index_copy(0, idx, self._scratch_rows(idx))
        return dataclasses.replace(sst, spec=dataclasses.replace(sst.spec, table=table))


class ServingLongSpecEngine(ServingEngine, LongSpecEngine):
    """Continuous-batching serving with a standalone draft model (the JAX
    package's ``ServingLongSpecEngine``): the per-request lifecycle of
    ``ServingEngine``, the draft model, its encode per draft-cache mode
    (full, streamingllm, snapkv) and its window of ``LongSpecEngine``."""


class PagedServingLongSpecEngine(PagedServingEngine, LongSpecEngine):
    """``ServingLongSpecEngine`` over the target's page pool (the JAX
    package's ``PagedServingLongSpecEngine``): the pool and page tables of
    ``PagedServingEngine``; the draft's cache stays contiguous a slot."""
