"""The serving slice as a whole: repro_torch's Engine, prefix cache and
launcher on the reduced yi-6b, on the CPU, against the JAX package's Engine
with the same parameters (carried over with `repro_torch.convert`) and the
same numpy prompts.

Greedy tokens are compared exactly: the logits agree to ~1e-6
(tests/test_torch_decode.py), far inside the gaps between the top logits
of these prompts. The prefix contract is bitwise within the port, as in the
reference.
"""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import serve as jserve
from repro.models import model as JM
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch import serve as tserve
from repro_torch.launch import serve as tlaunch
from repro_torch.models import decode as TD

MAX_SEQ = 40


@pytest.fixture(scope="module")
def models():
    """(JAX cfg, JAX params, port cfg, port params) per cache: f32 / 8-bit."""
    out = {}
    params = JM.init_params(jax.random.key(0), jconfigs.get_reduced("yi-6b"))
    tparams = convert.from_numpy(jax.tree.map(np.asarray, params))
    for bits in (None, 8):
        cfg = dataclasses.replace(jconfigs.get_reduced("yi-6b"),
                                  kv_quant_bits=bits)
        tcfg = dataclasses.replace(tconfigs.get_reduced("yi-6b"),
                                   kv_quant_bits=bits)
        out[bits] = (cfg, params, tcfg, tparams)
    return out


def _workload(vocab):
    rng = np.random.default_rng(7)
    prefix = rng.integers(0, vocab, 10).astype(np.int32)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in (6, 6, 4)]
    return prefix, prompts


def _run(mod, cfg, params, **engine_kw):
    """3 requests on 2 slots: two cold, one against a registered prefix;
    the third waits for a slot to free."""
    prefix, prompts = _workload(cfg.vocab_size)
    eng = mod.Engine(cfg, params, mod.ServeConfig(slots=2, max_seq=MAX_SEQ),
                     **engine_kw)
    eng.register_prefix("sys", prefix)
    for rid, (p, pid, n) in enumerate(zip(prompts, (None, "sys", None),
                                          (5, 3, 4))):
        eng.submit(mod.Request(rid=rid, prompt=p, max_new_tokens=n,
                               prefix_id=pid))
    return {r.rid: (r.tokens_out, r.admission)
            for r in eng.run_to_completion()}


@pytest.mark.parametrize("bits", [8, None], ids=["quant8", "f32"])
def test_engine_matches_jax_engine(models, bits):
    cfg, params, tcfg, tparams = models[bits]
    got = _run(tserve, tcfg, tparams, device="cpu")
    want = _run(jserve, cfg, params)
    assert got == want
    assert [got[i][1] for i in range(3)] == ["cold", "prefix_cold", "cold"]


def test_prefix_entry_survives_later_decode_steps(models):
    """The engine updates its caches in place; a cached prefix entry must
    hold copies. Snapshot the entry after `put`, keep decoding in the same
    slots, and check the entry did not move."""
    _, _, tcfg, tparams = models[8]
    prefix, prompts = _workload(tcfg.vocab_size)
    eng = tserve.Engine(tcfg, tparams,
                        tserve.ServeConfig(slots=1, max_seq=MAX_SEQ),
                        device="cpu")
    eng.register_prefix("sys", prefix, prefill=True)
    entry = eng.prefix_cache.peek("sys")
    snap = {k: v.clone() for k, v in entry.state.caches.items()}
    for rid in range(2):
        eng.submit(tserve.Request(rid=rid, prompt=prompts[rid],
                                  max_new_tokens=4, prefix_id="sys"))
    eng.step()
    # a mid-run snapshot of the live slot (what verify_prefix_contract
    # compares) must not move when the engine decodes on
    mid = TD.extract_slot(eng.state, 0, trim=False)
    mid_copy = {k: v.clone() for k, v in mid.caches.items()}
    eng.run_to_completion()
    assert eng.prefix_cache.hits == 2
    for name, x in entry.state.caches.items():
        assert torch.equal(x, snap[name]), name
        assert torch.equal(mid.caches[name], mid_copy[name]), name
        live = eng.state.caches[name]
        assert x.data_ptr() != live.data_ptr() or name == "signs"


@pytest.mark.parametrize("bits", [8, None], ids=["quant8", "f32"])
def test_verify_prefix_contract_holds(models, bits):
    _, _, tcfg, tparams = models[bits]
    prefix, prompts = _workload(tcfg.vocab_size)
    evidence = tserve.verify_prefix_contract(
        tcfg, tparams, tserve.ServeConfig(slots=2, max_seq=MAX_SEQ),
        prefix, prompts[0], device="cpu")
    assert evidence["tokens"] == 4
    want_entry = TD.state_bytes(TD.extract_slot(
        TD.prefill(tcfg, tparams, torch.from_numpy(prefix)[None], MAX_SEQ)[1],
        0))
    assert evidence["entry_bytes"] == want_entry


def test_extend_prefix_matches_a_longer_suffix(models):
    """`extend_prefix(p, more)` then a hit on suffix s decodes the same
    tokens as a hit on p with prompt more + s."""
    _, _, tcfg, tparams = models[8]
    scfg = tserve.ServeConfig(slots=1, max_seq=MAX_SEQ)
    prefix = np.arange(8, dtype=np.int32) + 1
    more, suffix = np.asarray([5, 9, 2], np.int32), np.asarray([7, 4],
                                                              np.int32)
    outs = []
    for extend in (True, False):
        eng = tserve.Engine(tcfg, tparams, scfg, device="cpu")
        eng.register_prefix("p", prefix, prefill=True)
        if extend:
            eng.extend_prefix("p", more)
            prompt = suffix
        else:
            prompt = np.concatenate([more, suffix])
        eng.submit(tserve.Request(rid=0, prompt=prompt, max_new_tokens=4,
                                  prefix_id="p"))
        (r,) = eng.run_to_completion()
        assert r.admission == "prefix_hit"
        outs.append(r.tokens_out)
    assert outs[0] == outs[1]


def test_engine_guards_and_exhaustion(models):
    _, _, tcfg, tparams = models[None]
    scfg = tserve.ServeConfig(slots=1, max_seq=16)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.Engine(tcfg, tparams, scfg)
    eng = tserve.Engine(tcfg, tparams, scfg, device="cpu")
    with pytest.raises(KeyError):
        eng.submit(tserve.Request(rid=0, prompt=[1, 2], prefix_id="nope"))
    with pytest.raises(ValueError):
        eng.register_prefix("long", np.zeros(16, np.int32))
    eng.submit(tserve.Request(rid=0, prompt=[1, 2, 3], max_new_tokens=8))
    with pytest.raises(tserve.EngineExhausted) as info:
        eng.run_to_completion(max_steps=2)
    assert info.value.active == 1 and info.value.steps == 2
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sched = tserve.BatchScheduler(tcfg, tparams, slots=1, max_seq=16,
                                      device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert isinstance(sched, tserve.Engine)


def test_loadgen_trace_and_play(models):
    _, _, tcfg, tparams = models[8]
    lcfg = tserve.LoadConfig(n_requests=4, prompt_len=(2, 4),
                             max_new_tokens=(2, 3), base_rate=1e4,
                             burst_rate=1e4, seed=3)
    prefix = np.arange(6, dtype=np.int32)
    trace = tserve.generate(lcfg, tcfg.vocab_size, prefix_id="sys",
                            prefix_tokens=prefix)
    again = tserve.generate(lcfg, tcfg.vocab_size, prefix_id="sys",
                            prefix_tokens=prefix)
    assert [(a.time, list(a.request.prompt)) for a in trace] == \
        [(a.time, list(a.request.prompt)) for a in again]
    eng = tserve.Engine(tcfg, tparams,
                        tserve.ServeConfig(slots=2, max_seq=MAX_SEQ),
                        device="cpu")
    eng.register_prefix("sys", prefix)
    out = tserve.play(eng, trace)
    assert len(out["finished"]) == 4
    assert all(r.ttft_s is not None and r.ttft_s >= 0
               for r in out["finished"])


def test_launcher_runs_on_cpu(capsys):
    seqs = tlaunch.main(["--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "6", "--gen", "3"])
    assert tuple(seqs.shape) == (2, 3)
    assert "tok/s" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tlaunch.main(["--reduced", "--gen", "2"])
