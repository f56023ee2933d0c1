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

Differences from the reference: `backend="mesh"` (lanes sharded over
devices, `repro.fed.mesh`) is not ported and raises; the port makes no
`repro.obs` calls (no spans, counters or recompile registry); per-lane
delta norms are computed only when adaptive re-allocation reads them.
A federation runs on `device` (`cuda` unless asked for the CPU): params,
shards and PRNG lanes are moved there.
"""
from __future__ import annotations

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
from repro_torch.fed import server as server_lib

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
    `backend` must be "vmap" (lanes of a cohort on the one device)."""

    def __init__(self, loss_fn: Callable, params, datas: Sequence,
                 codecs, client_cfgs=None,
                 server_cfg: server_lib.ServerConfig = None, seed: int = 0,
                 use_cohorts: bool = True,
                 adaptive: Optional[budget_lib.AdaptiveConfig] = None,
                 codec_factory: Optional[Callable] = None,
                 backend: str = "vmap", device=None):
        m = len(datas)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {backend!r}")
        if backend == "mesh":
            raise NotImplementedError(
                'backend="mesh" (cohort lanes sharded over devices, '
                "repro.fed.mesh) is not ported yet: ROADMAP queue 1 item 5, "
                "with dist/{sharding,zero}")
        self.backend = backend
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
                self._round_fns[k] = clients_lib.make_client_round(
                    self.loss_fn, self.codecs[i], self.client_cfgs[i],
                    self.server.params)
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

    def _run_clients(self, participants: Sequence[int],
                     round_idx: int) -> tuple:
        """Every participant through its cohort (lanes) or scalar round;
        returns ({client_id: host wire}, [(members, stacked decoded deltas,
        per-lane norms or None), ...]) and updates the states in place."""
        wires_of: dict = {}
        groups: list = []
        parts = partition_cohorts(
            [(i, self._cohort_keys[i] if self.use_cohorts else None)
             for i in participants])
        for key, members in parts:
            if key is not None and len(members) > 1:
                wires, new_states, decoded = self._run_cohort(
                    key, members, round_idx)
                # one copy of every lane's wire to the host for the ledger
                h_wires = _to_host(wires)
                for lane, i in enumerate(members):
                    wires_of[i] = codec_base.lane(h_wires, lane)
                    self.states[i] = codec_base.lane(new_states, lane)
                groups.append((members, decoded, self._norms(decoded)))
            else:
                for i in members:
                    wire, self.states[i] = self._fn_of[i](
                        self.server.params, self.datas[i], self.states[i],
                        round_idx)
                    decoded = tree_lib.map(
                        lambda x: x[None],
                        self.codecs[i].decode(wire, self.metas[i]))
                    wires_of[i] = _to_host(wire)
                    groups.append(([i], decoded, self._norms(decoded)))
        return wires_of, groups

    def _run_cohort(self, key, members: Sequence[int], round_idx: int):
        """One cohort as lanes: the client round, then the server's decode
        of every lane (one decode launch per leaf)."""
        i0 = members[0]
        fn = self._cohort_fns.get(key)
        if fn is None:
            fn = clients_lib.make_cohort_round(
                self.loss_fn, self.codecs[i0], self.client_cfgs[i0],
                self.server.params)
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
        wires, new_states = fn(self.server.params, data, state, round_idx)
        decoded = codec_base.decode_lanes(self.codecs[i0], wires,
                                          self.metas[i0], len(members))
        return wires, new_states, decoded

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
        realloc = self._maybe_reallocate(round_idx)
        participants, stragglers = self.sample_participants(cfg, round_idx)
        wires_of, groups = self._run_clients(participants, round_idx)
        realized = analytic = 0.0
        for i in participants:
            realized += self.codecs[i].wire_bytes(wires_of[i], self.metas[i])
            analytic += self._analytic_bits[i] / 8.0
        if participants:
            weights = self._weights(cfg, participants)
            slot_weights = (self._weights(cfg, range(self.num_clients))
                            if (self.server_cfg.aggregator == "fedmem"
                                and cfg.weighting != "uniform") else None)
            self._aggregate(groups, participants, weights, slot_weights)
        return {"round": round_idx, "participants": participants,
                "stragglers": stragglers, "wire_bytes": realized,
                "analytic_bytes": analytic, "realloc": realloc,
                "rates": (self._rates.tolist()
                          if self._rates is not None else None)}

    def _aggregate(self, groups, participants, weights,
                   slot_weights) -> None:
        if self.use_cohorts:
            stacked, order, norms = self._combine_groups(groups,
                                                         participants)
            if self._ema is not None:
                self._ema.update(order, norms.cpu().to(torch.float64)
                                 .numpy())
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

    def _weights(self, cfg: FedConfig, participants) -> np.ndarray:
        if cfg.weighting == "data_size":
            return np.array([clients_lib.num_examples(self.datas[i])
                             for i in participants], dtype=np.float64)
        return np.ones(len(participants))

    # -- full run ------------------------------------------------------------
    def run(self, cfg: FedConfig,
            eval_fn: Optional[Callable[[Any], float]] = None) -> dict:
        """Drive `cfg.num_rounds` rounds from `self.rounds_done`; returns
        the per-round history: round, loss (if eval_fn), wire_bytes,
        analytic_bytes, cum_bytes, participants, stragglers, realloc,
        rates."""
        hist = {k: [] for k in ("round", "loss", "wire_bytes",
                                "analytic_bytes", "cum_bytes",
                                "participants", "stragglers", "realloc",
                                "rates")}
        cum = 0.0
        start = self.rounds_done
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
                hist["loss"].append(float(eval_fn(self.server.params)))
        return hist
