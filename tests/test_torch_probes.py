"""The ported construct probes (`cvo_rgbd_torch.probes`, plain versions
on the CPU) against their closed forms and against the JAX package's
probe scripts, run on the CPU in interpret mode.

The scripts are run as they are, through runpy, with `pl.pallas_call`
given `interpret=True`; their tiled aligns (f, g, g2_x2_y1, g3_x1_y2)
are recorded on the way, so each runs once.  In interpret mode a TPU
scratch starts as NaN, and cases b, d and e read theirs before writing
it: their TPU values are undefined, so only their closed forms are held.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

import cvo_rgbd_tpu.ops.pallas_align as pa
from cvo_rgbd_torch import probes
from cvo_rgbd_torch.convert import cloud_from_numpy, params_from_jax_dict
from cvo_rgbd_torch.ops.align_fused import fused_mode

torch.set_num_threads(2)

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
# the toy cases whose TPU scratch is read before it is written
UNDEFINED_ON_TPU = ("b", "d", "e")
# each script's tiled aligns, in the order it runs them
SCRIPT_ALIGNS = {"tpu_construct_probe.py": ("f", "g"),
                 "tpu_construct_probe2.py": ("g2_x2_y1", "g3_x1_y2")}


@pytest.fixture(scope="module")
def jax_runs():
    """({case: val} as the scripts print them, {align case: (args,
    AlignResult)}) from both scripts in interpret mode."""
    import runpy

    from jax.experimental import pallas as pl

    vals, aligns, calls = {}, {}, []
    orig_call, orig_align = pl.pallas_call, pa.align_fused

    def interpret_call(*args, **kw):
        kw["interpret"] = True
        return orig_call(*args, **kw)

    def recording_align(p, x, y, *args, **kw):
        res = orig_align(p, x, y, *args, **kw)
        calls.append((p, x, y, res))
        return res

    pl.pallas_call, pa.align_fused = interpret_call, recording_align
    try:
        for script, names in SCRIPT_ALIGNS.items():
            out = io.StringIO()
            calls.clear()
            with contextlib.redirect_stdout(out):
                runpy.run_path(os.path.join(SCRIPTS, script),
                               run_name="__main__")
            lines = out.getvalue().splitlines()
            assert lines[-1] == "DONE"
            for line in lines:
                if line.startswith("{"):
                    rec = json.loads(line)
                    assert rec["ok"], rec
                    vals[rec["case"]] = rec["val"]
            assert len(calls) == len(names)
            aligns.update(zip(names, calls))
    finally:
        pl.pallas_call, pa.align_fused = orig_call, orig_align
    return vals, aligns


@pytest.mark.parametrize("case", probes.CASES)
def test_plain_probe_gives_its_closed_form(case):
    out = probes.construct_probe(case, *probes.inputs(case, "cpu"))
    assert out.shape == probes.OUT_SHAPE and out.dtype == torch.float32
    assert probes.closed_form_ok(case, float(out[0, 0]))
    rtol = probes.E_RTOL if case == "e" else 0.0
    if case in ("c", "h", "i", "j"):
        # the sum sits in row 0 only, as the TPU cases' where(row == 0)
        np.testing.assert_allclose(out[0].numpy(), probes.CLOSED[case])
        assert not out[1:].any()
    else:
        np.testing.assert_allclose(out.numpy(), probes.CLOSED[case],
                                   rtol=rtol)


@pytest.mark.parametrize("case", probes.CASES)
def test_probe_matches_the_jax_script(jax_runs, case):
    vals, _ = jax_runs
    got = float(probes.construct_probe(case, *probes.inputs(case, "cpu"))[0, 0])
    if case in UNDEFINED_ON_TPU:
        # the interpret-mode scratch starts as NaN, and the case reads it
        assert np.isnan(vals[case])
        assert probes.closed_form_ok(case, got)
    else:
        assert got == vals[case] == probes.CLOSED[case]


@pytest.mark.parametrize("case", probes.CASES)
def test_probe_bound_counts_what_the_result_depends_on(case):
    """chip_smoke.py's probe bound reads the input slices of PROBE_READS:
    the result is the same with every other input element NaN, and a NaN
    in the middle of any one of those slices reaches it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(SCRIPTS, "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    reads = smoke.PROBE_READS[case]
    ins = probes.inputs(case, "cpu")
    ref = probes.construct_probe_plain(case, *ins)
    kept = [torch.full_like(t, float("nan")) for t in ins]
    for i, s in reads:
        kept[i][s] = ins[i][s]
    assert torch.equal(probes.construct_probe_plain(case, *kept), ref)
    for i, (rows, cols) in reads:
        r = range(*rows.indices(ins[i].shape[0]))
        c = range(*cols.indices(ins[i].shape[1]))
        poisoned = [t.clone() for t in ins]
        poisoned[i][r[len(r) // 2], c[len(c) // 2]] = float("nan")
        assert not torch.equal(
            probes.construct_probe_plain(case, *poisoned), ref)


def test_probe_wrapper_rejects_unknown_cases():
    with pytest.raises(ValueError, match="unknown probe case"):
        probes.construct_probe("z", torch.zeros(1, 8))


def _port(cloud):
    return cloud_from_numpy(*(np.asarray(a) for a in cloud), device="cpu")


@pytest.mark.parametrize("case", list(probes.ALIGNS))
def test_tiled_align_matches_jax(jax_runs, case):
    """The port's tiled kernel (plain version) on the scripts' problems,
    N != M and a single fixed-row tile included, against the JAX tiled
    kernel the scripts forced: the tolerances of test_torch_fused.py."""
    _, aligns = jax_runs
    jp, jx, jy, ref = aligns[case]
    p, x, y = probes.tiled_problem(case, "cpu")
    # the same problem as the script's (the backend is the mode's forcing)
    want = dataclasses.asdict(params_from_jax_dict(dataclasses.asdict(jp)))
    have = dataclasses.asdict(p)
    assert {k: v for k, v in have.items() if k != "backend"} == {
        k: v for k, v in want.items() if k != "backend"}
    for got_c, ref_c in ((x, jx), (y, jy)):
        for a, b in zip(got_c, _port(ref_c)):
            assert torch.equal(a, b)
    got = probes.tiled_align(case, "cpu")
    assert float(got.iterations) == jax_runs[0][case]
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    np.testing.assert_allclose(got.tf.numpy(), np.asarray(ref.tf), atol=3e-4)
    assert float(got.ell) == float(ref.ell)
    # forced: at these sizes the port would run them resident
    assert fused_mode(p, x, y) == "resident"


def test_probes_entry_point(capsys):
    assert probes.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "DONE"
    recs = [json.loads(line) for line in lines[:-1]]
    assert [r["case"] for r in recs] == list(probes.CASES) + list(
        probes.ALIGNS)
    assert all(r["ok"] for r in recs)
