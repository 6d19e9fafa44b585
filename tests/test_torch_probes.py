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


SEEDS = (0, 1)


def _reference64(case, ins):
    """Case `case` transcribed in float64 numpy from the scripts:
    (the [8, 128] result, the tolerance on each output).  Where the
    float32 plain version rounds once (a, c) or not at all (b2, d, k),
    the result is rounded to float32 and the tolerance is 0; b rounds
    three times, 1e-6 of it; the sums take 1e-6 (e, h, i) or 1e-5 (j) of
    the sum of their terms' magnitudes."""
    x = ins[0]
    out = np.zeros(probes.OUT_SHAPE)
    tol = np.zeros(probes.OUT_SHAPE)
    if case == "a":
        out[:] = x * 2.0 + 1.0
    elif case == "b":
        s = np.zeros((8, 1024))
        for acc in (1.0, 2.0, 3.0):
            s[:, 256:512] += x[:, 0:256] * acc
        out[:] = s[:, 256:384]
        tol[:] = 1e-6 * np.abs(out)
    elif case == "b2":
        out[:] = x[0:8, 0:128]
    elif case == "c":
        out[0] = x[0, 0] + x[0, 159]
    elif case == "d":
        out[:] = 3.0 if x[0, 0] > -1.0 else 0.0
    elif case == "e":
        if x[0, 0] > -1.0:
            a, b = ins[1][:, 0:8], ins[2][:, 0:128]
            out[:] = 3 * (a.T @ b)
            tol[:] = 1e-6 * 3 * (np.abs(a).T @ np.abs(b))
    elif case == "h":
        out[0] = np.sum(x[256:512, 0])
        tol[0] = 1e-6 * np.sum(np.abs(x[256:512, 0]))
    elif case == "i":
        out[0] = np.sum(2.0 * x[0, 256:512])
        tol[0] = 1e-6 * np.sum(np.abs(2.0 * x[0, 256:512]))
    elif case == "j":
        d = x[256:512, 0][:, None] - 2.0 * ins[1][0, 256:512][None, :]
        out[0] = np.sum(d * d)
        tol[0] = 1e-5 * out[0, 0]
    elif case == "k":
        s = np.zeros((128, 512))
        for _ in range(2):
            s[:] = 0.0
            s[:, 256:512] += 2.0
        out[:] = s[0:8, 256:384]
    if case in ("a", "b2", "c", "d", "k"):
        out = out.astype(np.float32).astype(np.float64)
    return out, tol


def test_seeded_inputs_are_the_scripts_shapes_drawn_from_the_seed():
    for case in probes.CASES:
        ins = probes.seeded_inputs(case, "cpu", 0)
        script = probes.inputs(case, "cpu")
        assert [t.shape for t in ins] == [t.shape for t in script]
        assert all(t.dtype == torch.float32 for t in ins)
        again = probes.seeded_inputs(case, "cpu", 0)
        other = probes.seeded_inputs(case, "cpu", 1)
        for i, (t, u, v) in enumerate(zip(ins, again, other)):
            assert torch.equal(t, u)
            if case in probes.GUARDED and i == 0:
                assert (t == 0.0).all()
                continue
            assert not torch.equal(t, v)
            assert bool((t >= 0.5).all()) and bool((t < 1.5).all())
            # on the 2^-23 grid: exact in float32 and in float64
            q = t.double() * 2.0 ** 23
            assert torch.equal(q, torch.round(q))
    off = probes.seeded_inputs("e", "cpu", 0, guard=probes.GUARD_OFF)
    assert (off[0] == probes.GUARD_OFF).all()
    assert torch.equal(off[1], probes.seeded_inputs("e", "cpu", 0)[1])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", probes.CASES)
def test_plain_probe_matches_float64_on_seeded_inputs(case, seed):
    ins = probes.seeded_inputs(case, "cpu", seed)
    got = probes.construct_probe(case, *ins)
    assert got.shape == probes.OUT_SHAPE and got.dtype == torch.float32
    want, tol = _reference64(case, [t.numpy().astype(np.float64)
                                    for t in ins])
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= tol).all(), (case, err.max())
    # the tolerance the card holds the kernel to is no looser (up to the
    # float64 rounding of two sums of magnitudes)
    assert (probes.tolerance(case, *ins).numpy() <= np.maximum(
        tol, 1e-6 * np.abs(want)) * (1 + 1e-12)).all()


@pytest.mark.parametrize("case", probes.GUARDED)
def test_plain_probe_with_the_guard_off_gives_zeros(case):
    ins = probes.seeded_inputs(case, "cpu", 0, guard=probes.GUARD_OFF)
    got = probes.construct_probe(case, *ins)
    assert got.shape == probes.OUT_SHAPE and not got.any()
    want, _ = _reference64(case, [t.numpy().astype(np.float64)
                                  for t in ins])
    assert not want.any()
    assert not probes.tolerance(case, *ins).any()


@pytest.mark.parametrize("case", [c for c in probes.CASES if c != "k"])
def test_a_closed_form_written_unread_fails_the_seeded_checks(case):
    """A kernel that wrote the scripts' closed form without reading its
    inputs would pass every check on the scripts' inputs; on seeded ones
    (d: with the guard off) it misses its plain version.  k reads no
    input: its result is a constant."""
    closed = probes.construct_probe_plain(case, *probes.inputs(case, "cpu"))
    forms = [probes.seeded_inputs(case, "cpu", s) for s in SEEDS]
    if case in probes.GUARDED:
        forms.append(probes.seeded_inputs(case, "cpu", 0,
                                          guard=probes.GUARD_OFF))
    missed = [not probes.within_tolerance(
        case, closed, probes.construct_probe_plain(case, *ins), ins)
        for ins in forms]
    assert any(missed)
    if case != "d":
        assert all(missed)


def test_time_fused_takes_the_seeded_inputs_of_an_older_package(
        monkeypatch):
    """`time_fused.py --probes` against a package from before
    `seeded_inputs` takes them from its sibling probes.py: the same
    tensors."""
    from cvo_rgbd_torch import time_fused

    assert time_fused.seeded_probes() is probes
    want = probes.seeded_inputs("j", "cpu", 1)
    monkeypatch.delattr(probes, "seeded_inputs")
    sibling = time_fused.seeded_probes()
    assert sibling is not probes
    for a, b in zip(sibling.seeded_inputs("j", "cpu", 1), want):
        assert torch.equal(a, b)


def test_probe_wrapper_rejects_wrong_shapes():
    with pytest.raises(ValueError, match="inputs of shapes"):
        probes.construct_probe_cuda("a", torch.zeros(8, 64))
    with pytest.raises(ValueError, match="inputs of shapes"):
        probes.construct_probe_cuda("j", torch.zeros(512, 1))


def test_probe_wrapper_rejects_unaligned_inputs():
    # the kernels read whole rows in 16-byte loads
    x = torch.zeros(8 * 1024 + 1)[1:].view(8, 1024)
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        probes.construct_probe_cuda("b", x)


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
