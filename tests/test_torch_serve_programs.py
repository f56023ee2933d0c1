"""The captured serve programs (`repro_torch.graph.Program` in
`serve.engine._programs` and `dist.step.make_serve_step`) on the CPU,
against the JAX package's jitted ones.

On the CPU a program runs eagerly, on static copies of its inputs after its
first call, so what is held here is what the card's graphs rest on:

  * the specializations: `tests/test_torch_serve.py`'s `_run` traffic (3
    requests on 2 slots, two cold, one against a prefix) adds the same
    `obs.recompile` counts under `serve.*` as `repro.serve.Engine` does,
    for the reduced yi-6b (f32 and 8-bit cache), mixtral-8x22b,
    arctic-480b, hymba-1.5b (8-bit) and xlstm-350m;
  * engine parity: the same traffic gives the JAX engine's tokens and
    admissions exactly, for every decoding family (the JAX parameters
    carried over with `convert.from_numpy`; greedy tokens, as in
    test_torch_serve.py);
  * the slot index: `scatter_slot` with a device index is bitwise the
    integer indexing it replaced, on every family's cache keys;
  * the wrapper: outputs keep value semantics, a state bound to other
    pointers gets a graph of its own and is never written through another
    one's, a traced int is no new specialization, and `graph.eager()`
    records nothing and gives the same results.

The card's side (graph against eager, bitwise) is `tests/test_torch_cuda.py`
and `chip_smoke.py` phase 15.
"""
import dataclasses
import functools
import gc
import weakref

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import model as JM
from repro.obs import recompile as jrecompile
from repro.serve import engine as jengine
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import graph
from repro_torch import serve as tserve
from repro_torch.dist import step as TS
from repro_torch.models import decode as TD
from repro_torch.models import model as TM
from repro_torch.obs import recompile
from repro_torch.serve import engine as tengine
from test_torch_serve import MAX_SEQ, _run

# what repro.serve.Engine compiles for _run's traffic (jax 0.9.0, CPU)
REFERENCE_DELTA = {"serve.decode_step": 1, "serve.prefill": 1,
                   "serve.admit_cold": 2, "serve.admit_prefix": 1}
CASES = [("yi-6b", None), ("yi-6b", 8), ("mixtral-8x22b", None),
         ("arctic-480b", None), ("hymba-1.5b", 8), ("xlstm-350m", None)]
IDS = [f"{a}-{'q8' if b else 'f32'}" for a, b in CASES]


def _serve_delta(rec, before) -> dict:
    """The serve.* specializations `rec` (either package's recompile
    registry) counts beyond `before`."""
    return {k: v for k, v in rec.delta(before, rec.counts()).items()
            if k.startswith("serve.")}


def _counted(rec, clear, fn):
    """fn()'s result and the serve.* specializations it added, the
    program caches cleared first (so each package compiles anew)."""
    clear()
    before = rec.counts()
    return fn(), _serve_delta(rec, before)


@pytest.fixture(scope="module")
def runs():
    """Per case: (port tokens, port delta, JAX tokens, JAX delta)."""
    out = {}
    params_of = {}
    for arch, bits in CASES:
        cfg = dataclasses.replace(jconfigs.get_reduced(arch),
                                  kv_quant_bits=bits)
        tcfg = dataclasses.replace(tconfigs.get_reduced(arch),
                                   kv_quant_bits=bits)
        if arch not in params_of:
            params = JM.init_params(jax.random.key(0), cfg)
            params_of[arch] = (params, convert.from_numpy(
                jax.tree.map(np.asarray, params)))
        params, tparams = params_of[arch]
        got = _counted(recompile, tengine._programs.cache_clear,
                       lambda: _run(tserve, tcfg, tparams, device="cpu"))
        want = _counted(jrecompile, jengine._compiled.cache_clear,
                        lambda: _run(jserve, cfg, params))
        out[(arch, bits)] = got + want + (tcfg, tparams)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_specializations_equal_the_reference(runs, case):
    _, got, _, want = runs[case][:4]
    assert want == REFERENCE_DELTA
    assert got == want


@pytest.mark.parametrize("case", CASES[2:], ids=IDS[2:])
def test_engine_matches_jax_engine_for_every_family(runs, case):
    got, _, want, _ = runs[case][:4]
    assert got == want
    assert [got[i][1] for i in range(3)] == ["cold", "prefix_cold", "cold"]


def test_second_engine_and_new_prompt_length(runs):
    """A second engine over the same (cfg, max_seq) compiles nothing; a
    new prompt length adds one cold admission."""
    tcfg, tparams = runs[("yi-6b", 8)][4:]
    _run(tserve, tcfg, tparams, device="cpu")         # warm the programs
    before = recompile.counts()
    _run(tserve, tcfg, tparams, device="cpu")
    assert _serve_delta(recompile, before) == {}
    eng = tserve.Engine(tcfg, tparams, tserve.ServeConfig(
        slots=2, max_seq=MAX_SEQ), device="cpu")
    eng.submit(tserve.Request(rid=0, prompt=np.arange(7, dtype=np.int32),
                              max_new_tokens=2))
    eng.run_to_completion()
    assert _serve_delta(recompile, before) == {"serve.admit_cold": 1}


def test_serve_step_registers_one_specialization_per_batch_shape(runs):
    tcfg, tparams = runs[("yi-6b", None)][4:]
    names = []
    cb = lambda name, fn: names.append(name)   # noqa: E731
    recompile.add_callback(cb)
    try:
        step = TS.make_serve_step(tcfg)
    finally:
        recompile.remove_callback(cb)
    assert names == ["dist.serve_step"]
    for batch in (1, 2, 1, 2):
        st = TD.init_decode_state(tcfg, batch, 16, device="cpu")
        step(tparams, st, torch.zeros((batch, 1), dtype=torch.int32))
    assert recompile.cache_size(step) == 2


def _scatter_slot_int(batched, single, slot: int):
    """`scatter_slot` as it was before slots became device indices."""
    for name, b in batched.caches.items():
        if name in TD.SHARED_CACHE_KEYS:
            continue
        s = single.caches[name]
        if name in TD.POSITIONAL_CACHE_KEYS:
            n = s.shape[2]
            b[:, slot, :n] = s[:, 0]
            b[:, slot, n:] = 0
        else:
            b[:, slot] = s[:, 0]
    pos = batched.pos.clone()
    pos[slot] = single.pos[0]
    return TD.DecodeState(caches=batched.caches, pos=pos)


def _random_state(cfg, batch, gen):
    st = TD.init_decode_state(cfg, batch, 24, device="cpu")
    for name, x in st.caches.items():
        if name in TD.SHARED_CACHE_KEYS:
            continue
        if x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=gen))
        else:
            x.copy_(torch.randint(-2 ** 31, 2 ** 31, x.shape, generator=gen,
                                  dtype=torch.int64).to(x.dtype))
    st.pos.copy_(torch.randint(1, 24, st.pos.shape, generator=gen))
    return st


@pytest.mark.parametrize("arch,bits", [
    ("yi-6b", None), ("yi-6b", 8), ("mixtral-8x22b", None),
    ("mixtral-8x22b", 8), ("arctic-480b", 8), ("hymba-1.5b", None),
    ("hymba-1.5b", 8), ("xlstm-350m", None)])
def test_scatter_slot_device_index_is_bitwise_the_integer_path(arch, bits):
    cfg = dataclasses.replace(tconfigs.get_reduced(arch), kv_quant_bits=bits)
    gen = torch.Generator()
    gen.manual_seed(3)
    batched = _random_state(cfg, 3, gen)
    donor = _random_state(cfg, 2, gen)
    for trim in (True, False):
        single = TD.extract_slot(donor, 1, trim=trim)
        want = _scatter_slot_int(TD.DecodeState(
            {k: v.clone() for k, v in batched.caches.items()},
            batched.pos.clone()), single, 2)
        for slot in (2, torch.tensor(2)):
            got = TD.scatter_slot(TD.DecodeState(
                {k: v.clone() for k, v in batched.caches.items()},
                batched.pos.clone()), single, slot)
            assert got.caches.keys() == want.caches.keys()
            for name in want.caches:
                a, b = got.caches[name], want.caches[name]
                assert a.dtype == b.dtype and torch.equal(
                    a.contiguous().view(torch.uint8),
                    b.contiguous().view(torch.uint8)), (name, trim)
            assert torch.equal(got.pos, want.pos)


def _decode(prog, params, state, steps):
    """`steps` greedy decode steps through `prog`: [(logits, pos)] as
    returned, each with a copy made at once."""
    tok = torch.zeros((state.pos.shape[0], 1), dtype=torch.int32)
    out = []
    for _ in range(steps):
        logits, new = prog(params, state, tok)
        assert all(new.caches[k] is state.caches[k] for k in state.caches)
        out.append((logits, logits.clone(), new.pos, new.pos.clone()))
        state, tok = new, TD.greedy_token(logits)
    return out, state


@pytest.fixture(scope="module")
def quant_yi():
    cfg = dataclasses.replace(tconfigs.get_reduced("yi-6b"), kv_quant_bits=8)
    return cfg, TM.init_params(0, cfg, "cpu")


def test_outputs_keep_value_semantics_and_equal_the_eager_arm(quant_yi):
    cfg, params = quant_yi
    prog = graph.Program(functools.partial(TD.decode_step, cfg),
                         TD.IN_PLACE_ARGS)
    got, st = _decode(prog, params, TD.init_decode_state(
        cfg, 2, MAX_SEQ, device="cpu"), 4)
    for logits, logits0, pos, pos0 in got:      # untouched by later calls
        assert torch.equal(logits, logits0) and torch.equal(pos, pos0)
    with graph.eager():
        want, st_eager = _decode(prog, params, TD.init_decode_state(
            cfg, 2, MAX_SEQ, device="cpu"), 4)
    assert prog._cache_size() == 1 and prog.graphs() == 1
    for (a, _, p, _), (b, _, q, _) in zip(got, want):
        assert torch.equal(a, b) and torch.equal(p, q)
    for name in st.caches:
        assert torch.equal(st.caches[name], st_eager.caches[name]), name


def test_a_state_on_other_pointers_gets_its_own_graph(quant_yi):
    cfg, params = quant_yi
    prog = graph.Program(functools.partial(TD.decode_step, cfg),
                         TD.IN_PLACE_ARGS)
    a = TD.init_decode_state(cfg, 2, MAX_SEQ, device="cpu")
    _, a = _decode(prog, params, a, 3)
    snap = {k: v.clone() for k, v in a.caches.items()}
    b = TD.init_decode_state(cfg, 2, MAX_SEQ, device="cpu")
    _, b = _decode(prog, params, b, 3)
    assert prog._cache_size() == 1 and prog.graphs() == 2
    for name, x in a.caches.items():
        assert torch.equal(x, snap[name]), name          # never written
        assert torch.equal(b.caches[name], snap[name]), name
    del a, b
    gc.collect()
    assert prog.graphs() == 0                # the graphs die with the caches


def test_traced_scalars_and_static_copies():
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k, x

    prog = graph.Program(fn)
    x = torch.arange(4.0)
    outs = []
    for k in (2, 3, 5):
        y, x_out = prog(x, k)
        assert torch.equal(y, x * k) and torch.equal(x_out, x)
        # a clone of the static copy: never the caller's tensor, nor the
        # buffer the next call overwrites
        assert x_out.data_ptr() != x.data_ptr()
        outs.append(x_out)
    assert len({o.data_ptr() for o in outs}) == 3
    assert prog._cache_size() == 1
    assert all(isinstance(k, torch.Tensor) and k.dim() == 0 for k in calls)
    prog(torch.arange(5.0), 2)
    prog(x, 2.0)
    assert prog._cache_size() == 3


def test_a_dead_program_frees_its_graphs_without_the_collector(quant_yi):
    """A program's graphs die with it by reference counting: the cyclic
    collector, which could run in the middle of another program's capture
    (where destroying a graph invalidates the capture), is not needed."""
    cfg, params = quant_yi
    prog = graph.Program(functools.partial(TD.decode_step, cfg),
                         TD.IN_PLACE_ARGS)
    st = TD.init_decode_state(cfg, 2, MAX_SEQ, device="cpu")
    _decode(prog, params, st, 2)
    (entry,) = prog._graphs.values()
    alive = weakref.ref(entry)
    del entry
    gc.disable()
    try:
        del prog
        assert alive() is None
    finally:
        gc.enable()
