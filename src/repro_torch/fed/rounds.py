"""The federated round driver (port of `repro.fed.rounds`): cohorts,
participation, stragglers, ledger.

`Federation` wires the pieces together: per-client shards + budgets →
registry codecs → client rounds → server decode + aggregate. The host loop
does participant sampling, straggler dropout, cohort bookkeeping and the
ledger, as in the reference.

Cohorts: participants are partitioned by the hashable key

    (codec.spec, ClientConfig, data signature)

and every cohort of ≥ 2 clients runs as lanes (`clients.make_cohort_round`:
one kernel launch per leaf for all lanes' encodes, and one per leaf for the
cohort's decode). Singleton cohorts, and clients whose codec has no spec,
take the scalar `make_client_round`. Lane l of a cohort is bitwise the
scalar round on client l, and `server.aggregate_stacked` under
`sum_mode="sequential"` is bitwise the list layout, so `use_cohorts=False`
(the scalar path and the list layout, the reference's oracle) gives the same
params, EF states and ledger bit for bit.

Where the reference's `device_get` moves a cohort's wires to the host for
the ledger, the port copies them in one batch and synchronizes once
(`_to_host`); decoded deltas stay on the device up to the params update.

Backends (`Federation(backend=...)`): "vmap" runs every cohort's lanes in
this process; "mesh" splits each cohort's lanes over the ranks of a
`torch.distributed` group (`repro_torch.fed.mesh`). Every rank then runs
the same Federation; a rank runs its block of each cohort's lanes, the
per-lane ledger bytes and norms come back in one gather of a small vector
per cohort, the new client states in one gather per state leaf, and the
server reduce is a collective fold, bitwise "vmap" under
`sum_mode="sequential"` (zero-weight padding lanes included).

Observability (`repro_torch.obs`), as in the reference: with a session
active, `run_round` emits host-side spans for the realloc / client-compute
/ decode / aggregate stages, and counters, gauges and a histogram sourced
from the round record (realized vs analytic wire bytes, participant /
straggler / cohort counts, lane counts); every round and decode program
registers with `obs.recompile` under the reference's name
("fed.round.cohort", …). Enabling obs leaves params, EF states and the
ledger bitwise unchanged. `run(..., obs=session)` activates a session for
the run and emits a run-level summary event.

Differences from the reference: per-lane delta norms are computed on the
vmap backend only when adaptive re-allocation reads them.
A federation runs on `device` (`cuda` unless asked for the CPU): params,
shards and PRNG lanes are moved there.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as rnd
from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.codecs import base as codec_base
from repro_torch.fed import budget as budget_lib
from repro_torch.fed import clients as clients_lib
from repro_torch.fed import mesh as mesh_lib
from repro_torch.fed import server as server_lib
from repro_torch.obs import core as obs_lib
from repro_torch.obs import recompile as recompile_lib

BACKENDS = ("vmap", "mesh")


@dataclasses.dataclass(frozen=True)
class FedConfig:
    num_rounds: int = 50
    participation: float = 1.0   # fraction of clients sampled per round
    dropout: float = 0.0         # straggler prob. among the sampled
    weighting: str = "uniform"   # "uniform" | "data_size"
    seed: int = 0

    def __post_init__(self):
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError("dropout must be in [0, 1)")
        if self.weighting not in ("uniform", "data_size"):
            raise ValueError(f"unknown weighting {self.weighting!r}")


def cohort_key(codec, client_cfg, data) -> Optional[tuple]:
    """Hashable cohort identity, or None when the client can't be cohorted
    (its codec has no spec)."""
    spec = getattr(codec, "spec", None)
    if spec is None:
        return None
    return (spec, client_cfg, clients_lib.data_signature(data))


def partition_cohorts(ids_and_keys: Sequence) -> list:
    """[(client_id, key-or-None), ...] → [(key, members), ...]: members in
    input order, cohorts in first-seen order, every None-keyed client a
    trailing singleton."""
    groups: dict = {}
    order: list = []
    singletons: list = []
    for i, k in ids_and_keys:
        if k is None:
            singletons.append((None, [i]))
            continue
        if k not in groups:
            groups[k] = []
            order.append(k)
        groups[k].append(i)
    return [(k, groups[k]) for k in order] + singletons


def _to_host(tree):
    """A copy of `tree` on the CPU: every CUDA leaf copied without waiting,
    then one synchronization for all of them."""
    leaves, spec = tree_lib.flatten(tree)
    if not any(x.is_cuda for x in leaves):
        return tree
    out = [x.to("cpu", non_blocking=True) if x.is_cuda else x
           for x in leaves]
    torch.cuda.synchronize()
    return tree_lib.unflatten(spec, out)


class Federation:
    """A client–server simulation over `m = len(datas)` clients.

    codecs / client_cfgs may be a single shared object or one per client.
    All clients see the same `loss_fn(params, batch)`, a torch function the
    clients differentiate with autograd. `use_cohorts=False`
    forces the scalar path and the list-layout aggregate; `adaptive` +
    `codec_factory` (rate → TreeCodec) turn on adaptive re-allocation.

    `backend` picks where cohort lanes run: "vmap" (default) all in this
    process; "mesh" split over the ranks of `group` (the default group
    when None, see `fed.mesh.default_mesh`), every rank running this same
    Federation. Bitwise "vmap" under `sum_mode="sequential"`. Requires
    `use_cohorts=True`; singletons and spec-less clients take the scalar
    path on every rank, as under "vmap"."""

    def __init__(self, loss_fn: Callable, params, datas: Sequence,
                 codecs, client_cfgs=None,
                 server_cfg: server_lib.ServerConfig = None, seed: int = 0,
                 use_cohorts: bool = True,
                 adaptive: Optional[budget_lib.AdaptiveConfig] = None,
                 codec_factory: Optional[Callable] = None,
                 backend: str = "vmap", group=None, device=None):
        m = len(datas)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if backend == "mesh" and not use_cohorts:
            raise ValueError('backend="mesh" places cohort lanes on ranks '
                             "— it requires use_cohorts=True")
        self.backend = backend
        self.group = ((group if group is not None
                       else mesh_lib.default_mesh())
                      if backend == "mesh" else None)
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        dev = self.device
        params = tree_lib.map(lambda x: x.to(dev), params)
        self.datas = [tree_lib.map(lambda x: x.to(dev), d) for d in datas]
        if client_cfgs is None:
            client_cfgs = clients_lib.ClientConfig()
        self.client_cfgs = (list(client_cfgs)
                            if isinstance(client_cfgs, (list, tuple))
                            else [client_cfgs] * m)
        codecs = (list(codecs) if isinstance(codecs, (list, tuple))
                  else [codecs] * m)
        if len(codecs) != m or len(self.client_cfgs) != m:
            raise ValueError("need one codec / client config per client")
        self.server_cfg = server_cfg or server_lib.ServerConfig()
        self.server = server_lib.init_server(params, self.server_cfg, m)
        key = rnd.key(seed, device=dev)
        self.states = [
            clients_lib.init_client_state(params, rnd.fold_in(key, i),
                                          self.client_cfgs[i])
            for i in range(m)]
        self.use_cohorts = use_cohorts
        self.adaptive = adaptive
        self.codec_factory = codec_factory
        if adaptive is not None:
            if codec_factory is None:
                raise ValueError("adaptive re-allocation needs a "
                                 "codec_factory (rate → TreeCodec)")
            rates = [getattr(c, "rate", None) for c in codecs]
            if any(r is None for r in rates):
                raise ValueError("adaptive re-allocation needs every initial "
                                 "codec to expose a `.rate`")
            self._rates = np.asarray([float(r) for r in rates])
            self._ema = budget_lib.NormEMA(m, adaptive.ema_beta)
        else:
            self._rates = None
            self._ema = None
        # round programs are closures over (codec, config, meta): built once
        # per (spec, config) / cohort key and kept across re-allocations
        self._round_fns: dict = {}
        self._cohort_fns: dict = {}
        self._cohort_decode_fns: dict = {}
        self._decode_fns: dict = {}    # spec key -> scalar decode fn
        self._mesh_fns: dict = {}
        self._audit_bits: dict = {}    # spec key -> analytic wire_bits
        self._stacked_data: dict = {}  # cohort key -> (members, stacked)
        self.rounds_done = 0
        self._install_codecs(codecs)

    # -- codec tables --------------------------------------------------------
    def _spec_key(self, i: int):
        spec = getattr(self.codecs[i], "spec", None)
        return spec if spec is not None else self.codecs[i]

    def _fn_key(self, i: int) -> tuple:
        return (self._spec_key(i), self.client_cfgs[i])

    def _install_codecs(self, codecs: Sequence) -> None:
        m = self.num_clients
        self.codecs = list(codecs)
        self.metas = [c.meta(self.server.params) for c in self.codecs]
        for i in range(m):
            k = self._fn_key(i)
            if k not in self._round_fns:
                self._round_fns[k] = recompile_lib.register(
                    "fed.round.scalar", clients_lib.make_client_round(
                        self.loss_fn, self.codecs[i], self.client_cfgs[i],
                        self.server.params))
        self._fn_of = [self._round_fns[self._fn_key(i)] for i in range(m)]
        self._cohort_keys = [
            cohort_key(self.codecs[i], self.client_cfgs[i], self.datas[i])
            for i in range(m)]
        # the analytic audit, once per distinct codec spec
        for i in range(m):
            sk = self._spec_key(i)
            if sk not in self._audit_bits:
                self._audit_bits[sk] = float(
                    self.codecs[i].wire_bits(self.server.params))
        self._analytic_bits = [self._audit_bits[self._spec_key(i)]
                               for i in range(m)]

    def set_rates(self, rates: Sequence[float]) -> None:
        """Adopt new per-client budgets: rebuild codecs via `codec_factory`."""
        if self.codec_factory is None:
            raise ValueError("set_rates needs a codec_factory")
        rates = [float(r) for r in rates]
        self._rates = np.asarray(rates)
        self._install_codecs([self.codec_factory(r) for r in rates])

    @property
    def num_clients(self) -> int:
        return len(self.datas)

    # -- one round -----------------------------------------------------------
    def sample_participants(self, cfg: FedConfig, round_idx: int):
        """(participants, stragglers) — deterministic in (seed, round)."""
        m = self.num_clients
        rng = np.random.default_rng(
            np.random.PCG64(cfg.seed * 1_000_003 + round_idx))
        k = max(1, int(np.ceil(cfg.participation * m)))
        sampled = sorted(rng.choice(m, size=k, replace=False).tolist())
        if cfg.dropout <= 0.0:
            return sampled, []
        keep = rng.random(k) >= cfg.dropout
        participants = [c for c, kp in zip(sampled, keep) if kp]
        stragglers = [c for c, kp in zip(sampled, keep) if not kp]
        return participants, stragglers

    def _maybe_reallocate(self, round_idx: int) -> bool:
        if (self.adaptive is None or round_idx == 0
                or round_idx % self.adaptive.realloc_every != 0):
            return False
        new, changed = budget_lib.reallocate(self.adaptive, self._ema,
                                             self._rates)
        if changed:
            self.set_rates(new)
        return changed

    def _norms(self, decoded) -> Optional[torch.Tensor]:
        """Per-lane ℓ2 norms of a stacked decode, when the EMA reads them."""
        return None if self._ema is None else server_lib.stacked_norms(
            decoded)

    def _cohort_decode(self, key, i0: int):
        """The server's decode of a cohort's stacked wires (one decode
        launch per leaf for all lanes), built once per cohort key."""
        fn = self._cohort_decode_fns.get(key)
        if fn is None:
            codec, meta = self.codecs[i0], self.metas[i0]

            def decode_cohort(wires, lanes):
                return codec_base.decode_lanes(codec, wires, meta, lanes)

            fn = recompile_lib.register("fed.decode.cohort", decode_cohort)
            self._cohort_decode_fns[key] = fn
        return fn

    def _scalar_decode(self, i: int):
        """A singleton's decode, shaped like a 1-lane cohort (leading lane
        axis), built once per codec spec."""
        k = self._spec_key(i)
        fn = self._decode_fns.get(k)
        if fn is None:
            codec, meta = self.codecs[i], self.metas[i]

            def decode_one(wire):
                return tree_lib.map(lambda x: x[None],
                                    codec.decode(wire, meta))

            fn = recompile_lib.register("fed.decode.scalar", decode_one)
            self._decode_fns[k] = fn
        return fn

    def _run_clients(self, participants: Sequence[int],
                     round_idx: int) -> tuple:
        """Every participant through its cohort (lanes) or scalar round;
        returns ({client_id: realized wire bytes}, [(members, stacked
        decoded deltas, per-lane norms or None), ...]) and updates the
        states in place. A mesh cohort's decoded deltas are this rank's
        `mesh.LaneShard`."""
        bytes_of: dict = {}
        groups: list = []
        parts = partition_cohorts(
            [(i, self._cohort_keys[i] if self.use_cohorts else None)
             for i in participants])
        for key, members in parts:
            if key is not None and len(members) > 1 and (
                    self.backend == "mesh"):
                lane_bytes, new_states, decoded, norms = (
                    self._run_cohort_mesh(key, members, round_idx))
                for lane, i in enumerate(members):
                    bytes_of[i] = lane_bytes[lane]
                    self.states[i] = codec_base.lane(new_states, lane)
                groups.append((members, decoded,
                               None if self._ema is None else norms))
            elif key is not None and len(members) > 1:
                wires, new_states, decoded, norms = self._run_cohort(
                    key, members, round_idx)
                # one copy of every lane's wire to the host for the ledger
                h_wires = _to_host(wires)
                for lane, i in enumerate(members):
                    bytes_of[i] = self.codecs[i].wire_bytes(
                        codec_base.lane(h_wires, lane), self.metas[i])
                    self.states[i] = codec_base.lane(new_states, lane)
                groups.append((members, decoded, norms))
            else:
                for i in members:
                    obs_lib.observe_program_call(
                        "fed.round.scalar", self._fn_of[i],
                        (self.server.params, self.datas[i], self.states[i],
                         round_idx), span="fed.clients.compute",
                        wire_bytes=self._analytic_bits[i] / 8.0)
                    with obs_lib.span("fed.clients.compute", lanes=1,
                                      path="scalar"):
                        wire, self.states[i] = self._fn_of[i](
                            self.server.params, self.datas[i],
                            self.states[i], round_idx)
                    dfn = self._scalar_decode(i)
                    obs_lib.observe_program_call(
                        "fed.decode.scalar", dfn, (wire,), span="fed.decode")
                    with obs_lib.span("fed.decode", lanes=1, path="scalar"):
                        decoded = dfn(wire)
                        norms = self._norms(decoded)
                    bytes_of[i] = self.codecs[i].wire_bytes(
                        _to_host(wire), self.metas[i])
                    groups.append(([i], decoded, norms))
        return bytes_of, groups

    def _run_cohort(self, key, members: Sequence[int], round_idx: int):
        """One cohort as lanes: the client round, then the server's decode
        of every lane (one decode launch per leaf) and, when the EMA reads
        them, the lanes' norms."""
        i0 = members[0]
        fn = self._cohort_fns.get(key)
        if fn is None:
            fn = recompile_lib.register(
                "fed.round.cohort", clients_lib.make_cohort_round(
                    self.loss_fn, self.codecs[i0], self.client_cfgs[i0],
                    self.server.params))
            self._cohort_fns[key] = fn
        # shards never change: the stack is reused while the membership
        # repeats (always, at full participation)
        mtuple = tuple(members)
        cached = self._stacked_data.get(key)
        if cached is not None and cached[0] == mtuple:
            data = cached[1]
        else:
            data = clients_lib.stack_trees([self.datas[i] for i in members])
            self._stacked_data[key] = (mtuple, data)
        state = clients_lib.stack_trees([self.states[i] for i in members])
        obs_lib.observe_program_call(
            "fed.round.cohort", fn,
            (self.server.params, data, state, round_idx),
            span="fed.clients.compute",
            wire_bytes=len(members) * self._analytic_bits[i0] / 8.0)
        with obs_lib.span("fed.clients.compute", lanes=len(members),
                          path="vmap"):
            wires, new_states = fn(self.server.params, data, state,
                                   round_idx)
        dfn = self._cohort_decode(key, i0)
        obs_lib.observe_program_call("fed.decode.cohort", dfn,
                                     (wires, len(members)),
                                     span="fed.decode")
        with obs_lib.span("fed.decode", lanes=len(members), path="vmap"):
            decoded = dfn(wires, len(members))
            norms = self._norms(decoded)
        return wires, new_states, decoded, norms

    def _run_cohort_mesh(self, key, members: Sequence[int], round_idx: int):
        """One cohort with its lanes split over the ranks: the stacked data
        and states are padded by repeating lane 0 (`clients.stack_padded`),
        this rank runs its block. Returns the real lanes' ledger bytes, new
        states and norms (gathered: every rank holds every client's state)
        and the decoded deltas as this rank's `mesh.LaneShard`."""
        n, i0 = len(members), members[0]
        total = mesh_lib.padded_lanes(n, mesh_lib.lane_axis_size(self.group))
        fn = self._mesh_fns.get(key)
        if fn is None:
            fn = recompile_lib.register(
                "fed.round.mesh", mesh_lib.make_mesh_cohort_round(
                    self.loss_fn, self.codecs[i0], self.client_cfgs[i0],
                    self.server.params, self.group))
            self._mesh_fns[key] = fn
        mtuple = (tuple(members), total)
        cached = self._stacked_data.get(key)
        if cached is not None and cached[0] == mtuple:
            data = cached[1]
        else:
            data = clients_lib.stack_padded(
                [self.datas[i] for i in members], total)
            self._stacked_data[key] = (mtuple, data)
        state = clients_lib.stack_padded(
            [self.states[i] for i in members], total)
        obs_lib.observe_program_call(
            "fed.round.mesh", fn,
            (self.server.params, data, state, round_idx),
            span="fed.clients.compute",
            wire_bytes=n * self._analytic_bits[i0] / 8.0)
        with obs_lib.span("fed.clients.compute", lanes=n, padded=total,
                          path="mesh"):
            wires, new_states, decoded, norms = fn(self.server.params, data,
                                                   state, round_idx)
        # this rank's lanes' ledger bytes and norms: one small gather
        h_wires = _to_host(wires)
        lane_bytes = torch.tensor(
            [self.codecs[i0].wire_bytes(codec_base.lane(h_wires, lane),
                                        self.metas[i0])
             for lane in range(norms.shape[0])], dtype=torch.float64)
        small = mesh_lib.gather_lanes(
            torch.stack([lane_bytes.to(norms.device),
                         norms.to(torch.float64)], dim=1), total, self.group)
        states = tree_lib.map(lambda a: a[:n], mesh_lib.gather_lanes(
            new_states, total, self.group))
        return (small[:n, 0].tolist(), states,
                mesh_lib.LaneShard(decoded, total),
                small[:n, 1].to(torch.float32))

    @staticmethod
    def _combine_groups(groups: Sequence, participants: Sequence[int]):
        """Join per-cohort stacks into ONE stacked tree in participant order
        (the order the list layout reduces in), plus the lane order and the
        per-lane norms in group order."""
        order = [i for members, _, _ in groups for i in members]
        perm = None
        if order != list(participants):
            pos = {c: j for j, c in enumerate(order)}
            perm = np.asarray([pos[c] for c in participants], np.int64)
        stacked = clients_lib.concat_stacks([g[1] for g in groups], perm)
        norms = (None if groups[0][2] is None
                 else torch.cat([g[2] for g in groups]))
        return stacked, order, norms

    def run_round(self, cfg: FedConfig, round_idx: int) -> dict:
        with obs_lib.span("fed.round", round=round_idx,
                          backend=self.backend):
            rec, groups = self._run_round(cfg, round_idx)
        if obs_lib.enabled():
            self._emit_round_obs(rec, groups)
        return rec

    def _run_round(self, cfg: FedConfig, round_idx: int) -> tuple:
        with obs_lib.span("fed.round.realloc"):
            realloc = self._maybe_reallocate(round_idx)
        participants, stragglers = self.sample_participants(cfg, round_idx)
        with obs_lib.span("fed.round.clients",
                          participants=len(participants)):
            bytes_of, groups = self._run_clients(participants, round_idx)
        realized = analytic = 0.0
        for i in participants:
            realized += bytes_of[i]
            analytic += self._analytic_bits[i] / 8.0
        if participants:
            weights = self._weights(cfg, participants)
            slot_weights = (self._weights(cfg, range(self.num_clients))
                            if (self.server_cfg.aggregator == "fedmem"
                                and cfg.weighting != "uniform") else None)
            with obs_lib.span("fed.round.aggregate",
                              aggregator=self.server_cfg.aggregator,
                              participants=len(participants)):
                self._aggregate(groups, participants, weights, slot_weights)
        return ({"round": round_idx, "participants": participants,
                 "stragglers": stragglers, "wire_bytes": realized,
                 "analytic_bytes": analytic, "realloc": realloc,
                 "rates": (self._rates.tolist()
                           if self._rates is not None else None)},
                groups)

    def _aggregate(self, groups, participants, weights,
                   slot_weights) -> None:
        if (self.backend == "mesh" and len(groups) == 1
                and groups[0][0] == list(participants)):
            # single-cohort fast path: the rank's block of the decoded
            # stack feeds the collective fold directly
            members, decoded, norms = groups[0]
            if self._ema is not None:
                self._ema.update(members, norms.cpu().to(torch.float64)
                                 .numpy())
            self.server = mesh_lib.aggregate_stacked_mesh(
                self.server, self.server_cfg, decoded, weights, self.group,
                participants, slot_weights=slot_weights,
                lanes=len(participants))
        elif self.use_cohorts:
            if self.backend == "mesh":
                # multi-group join: every mesh cohort's lanes gathered and
                # cut to the real ones before the concat
                groups = [(mem, mesh_lib.gather_lanes(
                    dec.local, dec.total, self.group) if isinstance(
                        dec, mesh_lib.LaneShard) else dec, nr)
                    for mem, dec, nr in groups]
                groups = [(mem, tree_lib.map(lambda a, k=len(mem): a[:k],
                                             dec), nr)
                          for mem, dec, nr in groups]
            stacked, order, norms = self._combine_groups(groups,
                                                         participants)
            if self._ema is not None:
                self._ema.update(order, norms.cpu().to(torch.float64)
                                 .numpy())
            if self.backend == "mesh":
                self.server = mesh_lib.aggregate_stacked_mesh(
                    self.server, self.server_cfg, stacked, weights,
                    self.group, participants, slot_weights=slot_weights)
            else:
                self.server = server_lib.aggregate_stacked(
                    self.server, self.server_cfg, stacked, weights,
                    participants, slot_weights=slot_weights)
        else:
            # the list layout: per-participant trees, reduced left to right
            deltas = [tree_lib.map(lambda x: x[0], g[1]) for g in groups]
            if self._ema is not None:
                norms = torch.cat([g[2] for g in groups])
                self._ema.update([g[0][0] for g in groups],
                                 norms.cpu().to(torch.float64).numpy())
            self.server = server_lib.aggregate(
                self.server, self.server_cfg, deltas, weights,
                participants, slot_weights=slot_weights)

    def _emit_round_obs(self, rec: dict, groups: Sequence) -> None:
        """Round metrics, sourced from the finished round record and the
        host-side cohort bookkeeping."""
        obs_lib.counter("fed.rounds", 1)
        obs_lib.counter("fed.wire_bytes", rec["wire_bytes"])
        obs_lib.counter("fed.analytic_bytes", rec["analytic_bytes"])
        obs_lib.counter("fed.stragglers", len(rec["stragglers"]))
        if rec["realloc"]:
            obs_lib.counter("fed.reallocs", 1)
        obs_lib.gauge("fed.participants", len(rec["participants"]),
                      round=rec["round"])
        obs_lib.gauge("fed.cohorts", len(groups), round=rec["round"])
        for members, _, _ in groups:
            obs_lib.histogram("fed.cohort_lanes", len(members))

    def _weights(self, cfg: FedConfig, participants) -> np.ndarray:
        if cfg.weighting == "data_size":
            return np.array([clients_lib.num_examples(self.datas[i])
                             for i in participants], dtype=np.float64)
        return np.ones(len(participants))

    # -- full run ------------------------------------------------------------
    def run(self, cfg: FedConfig,
            eval_fn: Optional[Callable[[Any], float]] = None,
            obs: Optional[obs_lib.Obs] = None) -> dict:
        """Drive `cfg.num_rounds` rounds from `self.rounds_done`; returns
        the per-round history: round, loss (if eval_fn), wire_bytes,
        analytic_bytes, cum_bytes, participants, stragglers, realloc,
        rates. A federation restored by `repro_torch.checkpoint.
        restore_federation` continues with the same round indices as an
        uninterrupted run.

        `obs` activates a `repro_torch.obs` session for the run (an already
        active session instruments it the same way); the history is bitwise
        the same with and without it."""
        ctx = obs_lib.use(obs) if obs is not None else contextlib.nullcontext()
        with ctx:
            hist = {k: [] for k in ("round", "loss", "wire_bytes",
                                    "analytic_bytes", "cum_bytes",
                                    "participants", "stragglers", "realloc",
                                    "rates")}
            cum = 0.0
            start = self.rounds_done
            with obs_lib.span("fed.run", rounds=cfg.num_rounds,
                              start=start, backend=self.backend):
                for t in range(start, start + cfg.num_rounds):
                    rec = self.run_round(cfg, t)
                    self.rounds_done = t + 1
                    cum += rec["wire_bytes"]
                    hist["round"].append(t)
                    hist["wire_bytes"].append(rec["wire_bytes"])
                    hist["analytic_bytes"].append(rec["analytic_bytes"])
                    hist["cum_bytes"].append(cum)
                    hist["participants"].append(rec["participants"])
                    hist["stragglers"].append(rec["stragglers"])
                    hist["realloc"].append(rec["realloc"])
                    hist["rates"].append(rec["rates"])
                    if eval_fn is not None:
                        with obs_lib.span("fed.eval", round=t):
                            hist["loss"].append(
                                float(eval_fn(self.server.params)))
            session = obs_lib.get()
            if session is not None:
                session.meta(
                    "fed.run.summary", rounds=cfg.num_rounds,
                    start_round=start, backend=self.backend,
                    clients=self.num_clients,
                    total_wire_bytes=cum,
                    total_analytic_bytes=sum(hist["analytic_bytes"]),
                    stragglers=sum(len(s) for s in hist["stragglers"]),
                    reallocs=sum(bool(r) for r in hist["realloc"]),
                    final_loss=(hist["loss"][-1] if hist["loss"] else None))
        return hist
