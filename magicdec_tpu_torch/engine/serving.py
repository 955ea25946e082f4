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
would sample alone with that salt.

Under a mesh (``mesh=``, ``parallel/sharding.py``) the B slots split over
the data axis: data rank d holds slots [d * B/data, (d + 1) * B/data) and
runs the windows and admissions of those alone (tensor-parallel over its
model group).  Every rank runs the same host loop over every slot, so the
schedulers and allocators are replicated and decide alike; one collective
per sync (``_sync``) shares every slot's flags, committed count and
output.  ``PagedServingEngine`` splits its pool too (the JAX package's
page groups): each data group owns B/data scratch pages and total_pages /
data pages, its table rows hold group-local page ids
(``ops.shard.group_table_row``), and it has its own ``Scheduler`` and
``PageAllocator``; the head request goes to the group with the most free
pages among those with a free slot (strict FCFS), and a request must fit
one group's pages.  ``ServingEngine`` keeps one scheduler over every
slot, as the JAX package's.
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
from magicdec_tpu_torch.ops.shard import group_table_row

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
        """An empty batch of B slots, this rank's B / data of them
        (``total_pages`` sizes the page pool of ``PagedServingEngine``;
        contiguous slots have none).  Under sampling ``rng`` is the batch's
        stream key; the salts come with admission."""
        lo, hi = self._data_rows(B)
        Bl = hi - lo
        rng, _ = self._sampling_args(Bl, rng, None)
        tcaches, dcaches = self._zero_caches(Bl)
        return self._empty_state(tcaches, dcaches, Bl, rng=rng)

    # -- admission ----------------------------------------------------------

    def admit_many(self, sst: ServingState, admissions) -> ServingState:
        """Admit a wave: ``admissions`` = [(slot, prompt, request id), ...].
        Prompts are bucketed by length; each bucket prefills as ONE encode
        over its [k, P] prompts and is spliced into its slots.  The request
        id is the request's noise-stream salt under sampling.
        ``PagedServingEngine`` takes a fourth entry, the slot's table row
        [npr] int32: its pool pages (allocator pages offset past the scratch
        pages; unused tail entries = the slot's scratch page)."""
        Bl = sst.active.shape[0]
        lo = 0 if self.mesh is None else self.mesh.coords["data"] * Bl
        buckets: Dict[int, list] = {}
        for adm in admissions:
            if lo <= adm[0] < lo + Bl:  # this data rank's slots, as local ids
                buckets.setdefault(len(adm[1]), []).append((adm[0] - lo,) + tuple(adm[1:]))
        for group in buckets.values():
            slots = torch.as_tensor([g[0] for g in group], dtype=torch.long,
                                    device=self.device)
            stk = self._encode_tokens(self._tokens(np.stack([np.asarray(g[1]) for g in group])),
                                      [g[2] for g in group], sst.spec.rng)
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

    def _sched_groups(self) -> int:
        """Scheduler / allocator groups: one over every slot here (the JAX
        package's contiguous engine); ``PagedServingEngine``'s data groups."""
        return 1

    def _admission(self, slot: int, prompt, rid: int, alloc, aslot: int):
        return (slot, prompt, rid)

    def _drain(self, sst: ServingState, idx: torch.Tensor) -> ServingState:
        return ServingState(spec=sst.spec, active=sst.active.index_fill(0, idx, False),
                            done=sst.done.index_fill(0, idx, False))

    def _sync(self, sst: ServingState, passes: torch.Tensor) -> np.ndarray:
        """Every slot's [active, done, committed, passes, output...] as int32
        rows [B, 4 + out_cap] on the host: this rank's slots, gathered over
        the data ranks in one collective under a mesh.  Without a data axis
        active and done are read first, and only [B, 2] of them returned
        when no slot drained."""
        spec = sst.spec
        flags = torch.stack([sst.active.to(torch.int32), sst.done.to(torch.int32)], dim=1)
        if self._data_group is None:
            f = flags.cpu().numpy()
            if not (f[:, 0] & f[:, 1]).any():
                return f
        rows = torch.cat([flags, torch.stack([spec.num_committed, passes], dim=1), spec.output],
                         dim=1)
        return self._gather_data(rows).cpu().numpy()

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
        G = self._sched_groups()
        worst = -(-(max(len(p) for p in prompts) + reserve) // ps)
        if n_pages // G < worst:
            raise ValueError(f"total_pages={n_pages} over {G} group(s) cannot hold the longest "
                             f"request ({worst} pages a group needed)")
        sst = self.init_serving(B, total_pages=n_pages, rng=rng)
        Bs = B // G  # slots a scheduler group
        scheds = [native.Scheduler(Bs) for _ in range(G)]
        allocs = [native.PageAllocator(n_pages // G, ps, Bs, cap) for _ in range(G)]
        slot_pages: Dict[int, tuple] = {}  # batch slot -> (group, allocator slot)
        pending = deque(range(len(prompts)))
        t0 = time.perf_counter_ns()

        def now_us():
            return (time.perf_counter_ns() - t0) // 1000

        # every request arrives now; it is submitted to its group's scheduler
        # at admission with this stamp, so queue times measure real waiting
        arrivals = {rid: now_us() for rid in range(len(prompts))}
        results: Dict[int, np.ndarray] = {}
        passes_of: Dict[int, int] = {}
        # target passes each slot's request was live for (device; read at drain)
        passes = torch.zeros_like(sst.spec.num_committed)
        count = dict(waves=0, admitted=0, admit_s=0.0, windows=0, page_blocked=0,
                     min_free=sum(a.free_pages() for a in allocs))
        lo = self._data_rows(B)[0]

        def refill(sst):
            rows = self._sync(sst, passes)
            drained = [s for s in range(B) if rows[s, 0] and rows[s, 1]]
            mine = []
            for slot in drained:
                g, aslot = slot_pages.pop(slot)
                rid = scheds[g].complete(slot % Bs, now_us())
                allocs[g].release(aslot)
                results[rid] = rows[slot, 4:4 + int(rows[slot, 2])]
                passes_of[rid] = int(rows[slot, 3])
                if lo <= slot < lo + passes.shape[0]:
                    mine.append(slot - lo)
            if mine:
                idx = torch.as_tensor(mine, dtype=torch.long, device=self.device)
                passes.index_fill_(0, idx, 0)
                sst = self._drain(sst, idx)
            wave = []
            while pending:
                need_len = len(prompts[pending[0]]) + reserve
                need = -(-need_len // ps)
                free_slot = [g for g in range(G) if scheds[g].counts()[1] < Bs]
                cands = [g for g in free_slot if allocs[g].free_pages() >= need]
                if not cands:
                    # FCFS backpressure: the head of the line waits for pages
                    count["page_blocked"] += bool(free_slot)
                    break
                g = max(cands, key=lambda g: allocs[g].free_pages())
                rid = pending.popleft()
                scheds[g].submit(rid, arrivals[rid])
                got = scheds[g].assign(now_us(), max_n=1)
                assert got and got[0][0] == rid
                slot = g * Bs + got[0][1]
                aslot = allocs[g].admit(need_len)
                assert aslot >= 0
                slot_pages[slot] = (g, aslot)
                wave.append(self._admission(slot, prompts[rid], rid, allocs[g], aslot))
            count["min_free"] = min(count["min_free"], sum(a.free_pages() for a in allocs))
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
        qs = [s.stats() for s in scheds]
        ns = [s.counts()[2] for s in scheds]
        wmean = lambda i: sum(q[i] * n for q, n in zip(qs, ns)) / max(sum(ns), 1)
        gen = sum(len(results[i]) - 1 for i in results)
        self.last_serve_stats = {
            "mean_queue_ms": wmean(0) / 1e3, "mean_service_ms": wmean(1) / 1e3,
            "served": sum(ns), "admission_waves": count["waves"],
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
    verify appends its draft half there by K3).  Under a data axis each
    data rank's pool is its group's: B/data scratch pages, then
    total_pages / data pages, addressed by group-local ids.
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
        e, c = self.ecfg, self.cfg
        ps, npr = e.page_size, self._npr
        data = 1 if self.mesh is None else self.mesh.data
        total = B * npr if total_pages is None else total_pages
        if B % data or total % data:
            raise ValueError(f"paged serving over data={data}: slots B={B} and pool pages "
                             f"{total} must both divide by the data axis")
        B = B // data  # this rank's group: its slots, scratch pages and pages
        P = total // data + B
        rng, _ = self._sampling_args(B, rng, None)
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

    def _sched_groups(self) -> int:
        return 1 if self.mesh is None else self.mesh.data

    def _admission(self, slot: int, prompt, rid: int, alloc, aslot: int):
        # a group's pool pages 0..Bl-1 are its slots' scratch pages; the
        # unused tail points at the slot's own (never read)
        Bl = alloc.shape[0]
        return (slot, prompt, rid, group_table_row(alloc.tables()[0][aslot], slot % Bl, Bl))

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
