"""The port's dry-run (repro_torch.launch.dryrun, hlo_analysis) against the
reference's placement.

The port has no compiled program to read: its bytes per device are the
arguments' StateSpecs at `local_shape`, held here equal to the sum of the
reference's per-device shard bytes (`shard_shape` of its
serve_state_specs / train_state_specs and the batch's `batch_specs`) on
conftest's 4 CPU devices; its collectives are the decode step's plan run
on meta tensors (tests/test_torch_tensor_parallel.py holds that census
equal to the ranks' own counts). jax.eval_shape only: nothing compiles.
"""
from __future__ import annotations

import json
import math

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.dist import gradcomp as TG
from repro_torch.dist import sharding as TSH
from repro_torch.launch import dryrun
from repro_torch.launch import hlo_analysis
from repro_torch.launch import mesh as TMESH
from repro_torch.kernels import cost


def _reference_bytes(arch: str, shape_name: str, data: int, model: int):
    """Σ over the reference's step arguments of their per-device shard
    bytes on a (data, model) host mesh."""
    import jax
    from jax.sharding import NamedSharding
    from repro import configs as jconfigs
    from repro.configs.shapes import SHAPES, input_specs
    from repro.dist import step as JS
    from repro.dist.gradcomp import GradCompConfig
    from repro.dist.sharding import batch_specs
    from repro.launch.mesh import make_host_mesh
    from repro.optimizer import adamw
    cfg, shape = jconfigs.get(arch), SHAPES[shape_name]
    mesh = make_host_mesh(data=data, model=model)
    if shape.mode == "train":
        args = JS.train_state_specs(cfg, adamw(1e-4, weight_decay=0.1),
                                    GradCompConfig(), mesh)
        batch = input_specs(cfg, shape)
        args = args + (jax.tree.map(
            lambda x, s: jax.ShapeDtypeStruct(
                x.shape, x.dtype, sharding=NamedSharding(mesh, s)),
            batch, batch_specs(batch, mesh)),)
    else:
        args = JS.serve_state_specs(cfg, mesh, shape.global_batch,
                                    shape.seq_len)
    return sum(math.prod(x.sharding.shard_shape(x.shape)) * x.dtype.itemsize
               for x in jax.tree.leaves(args))


@pytest.mark.parametrize("arch", ["yi-6b", "mixtral-8x22b"])
@pytest.mark.parametrize("shape_name", ["decode_32k", "train_4k"])
@pytest.mark.parametrize("data, model", [(1, 4), (2, 2)])
def test_argument_bytes_equal_the_reference_shards(arch, shape_name, data,
                                                   model):
    want = _reference_bytes(arch, shape_name, data, model)
    got = dryrun.argument_bytes(
        tconfigs.get(arch), tconfigs.SHAPES[shape_name],
        TSH.MeshLayout(("data", "model"), (data, model)),
        TG.GradCompConfig(), dryrun.make_opt("adamw"))
    assert got == want


def test_record_on_the_production_mesh():
    """yi-6b × decode_32k on 16×16: OK, 256 devices, bytes_per_device the
    argument bytes there, the roofline with the H100's peaks; the 8-bit
    cache holds fewer bytes; nothing is compiled, so XLA's fields are
    null."""
    gc = TG.GradCompConfig()
    mesh = TMESH.make_production_mesh()
    rec = dryrun.run_combo("yi-6b", "decode_32k", False, gc, verbose=False)
    assert rec["status"] == "OK" and rec["num_devices"] == 256
    want = dryrun.argument_bytes(tconfigs.get("yi-6b"),
                                 tconfigs.SHAPES["decode_32k"], mesh, gc,
                                 dryrun.make_opt("adamw"))
    assert rec["bytes_per_device"] == want
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["xla_cost"] is None and rec["memory"]["temp_size_in_bytes"] \
        is None
    roof = rec["roofline"]
    assert roof["memory_s"] == want / cost.PEAK_BYTES_S
    assert roof["flops_per_device"] == hlo_analysis.model_flops_decode(
        tconfigs.get("yi-6b"), 128) / 256
    assert roof["compute_s"] == roof["flops_per_device"] / \
        cost.PEAK_F32_FLOP_S
    assert roof["collective_s"] == roof["collective_bytes_per_device"] / \
        cost.NVLINK_BYTES_S
    # 32 layers: q/k/v and the head gathered, the embedding, wo, W_down
    assert rec["collectives"]["all-gather"]["count"] == 33
    assert rec["collectives"]["all-reduce"]["count"] == 65
    q8 = dryrun.run_combo("yi-6b", "decode_32k", False, gc, verbose=False,
                          kv_quant=8)
    assert q8["bytes_per_device"] < rec["bytes_per_device"]
    multi = dryrun.run_combo("yi-6b", "train_4k", True, gc, verbose=False)
    assert multi["num_devices"] == 512 and multi["mesh"] == "2x16x16"


def test_skips_carry_the_reference_reasons():
    from repro import configs as jconfigs
    from repro.configs.shapes import SHAPES, applicable
    gc = TG.GradCompConfig()
    rec = dryrun.run_combo("phi3-mini-3.8b", "long_500k", False, gc,
                           verbose=False)
    ok, reason = applicable(jconfigs.get("phi3-mini-3.8b"),
                            SHAPES["long_500k"])
    assert not ok and rec["status"] == "SKIP" and rec["reason"] == reason
    enc = dryrun.run_combo("hubert-xlarge", "decode_32k", False, gc,
                           verbose=False)
    assert enc["status"] == "SKIP" and enc["reason"] == applicable(
        jconfigs.get("hubert-xlarge"), SHAPES["decode_32k"])[1]
    pre = dryrun.run_combo("yi-6b", "prefill_32k", False, gc, verbose=False)
    assert pre["status"] == "SKIP" and "one worker" in pre["reason"]


def test_sweep_both_meshes_on_meta(tmp_path, capsys):
    """`--sweep --both-meshes`: no FAIL; 44 OK records (the 36 others SKIP:
    the reference's reasons, and the port's prefill), each with its bytes
    and roofline."""
    out = tmp_path / "sweep.json"
    rc = dryrun.main(["--sweep", "--both-meshes", "--json-out", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 2 * len(tconfigs.ARCH_NAMES) * len(tconfigs.SHAPES)
    assert not [r for r in recs if r["status"] == "FAIL"]
    ok = [r for r in recs if r["status"] == "OK"]
    assert len(ok) == 44
    for r in ok:
        assert r["bytes_per_device"] > 0
        assert r["roofline"]["dominant"] in ("compute", "memory",
                                             "collective")
    assert "FAIL" not in capsys.readouterr().out


def test_production_mesh_is_a_layout():
    single, multi = (TMESH.make_production_mesh(),
                     TMESH.make_production_mesh(multi_pod=True))
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    assert TSH.num_workers(multi) == 32 and TSH.num_workers(single) == 16
    assert TSH.data_axis_names(multi) == ("pod", "data")
    assert TSH.data_axes_for(128, multi) == ("pod", "data")
    assert TSH.data_axes_for(16, multi) == ("data",)
    assert TSH.data_axes_for(1, multi) == ()
    with pytest.raises(ValueError, match="no ranks"):
        TSH.worker_index(single)
    assert not torch.distributed.is_initialized()
