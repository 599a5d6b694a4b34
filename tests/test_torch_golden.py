"""The golden dumps (validate/golden.py) and the capacity criterion
(validate/capacity.py) against mgcfd_tpu's: byte-identical files and the
same names for the same arrays, the same verdict dict from the same legs,
and each package judging the other's saved legs (the npz keys v rms
cycles device edges)."""
import json

import numpy as np
import pytest
import torch

from mgcfd_tpu.validate import capacity as jax_capacity
from mgcfd_tpu.validate import golden as jax_golden
from mgcfd_tpu_torch.validate import capacity, golden

torch.set_num_threads(1)


def arrays(seed=0, n=40):
    rng = np.random.default_rng(seed)
    # values across magnitudes and signs, a negative zero, a huge and a
    # tiny one: %.17e must print them alike
    v = rng.standard_normal((n, 5)) * 10.0 ** rng.integers(-20, 20, (n, 5))
    v[0, 0], v[1, 1], v[2, 2] = -0.0, 1e308, 5e-324
    return v


@pytest.mark.parametrize("writer", ["variables", "scalars", "edge_fluxes"])
def test_dumps_are_byte_identical(tmp_path, writer):
    v = arrays()
    mine, ref = tmp_path / "port" / "out", tmp_path / "jax" / "out"
    if writer == "variables":
        golden.dump_variables(str(mine), v)
        jax_golden.dump_variables(str(ref), v)
        pairs = [(mine, ref)]
    elif writer == "scalars":
        golden.dump_scalars(str(mine), v[:, 3])
        jax_golden.dump_scalars(str(ref), v[:, 3])
        pairs = [(mine, ref)]
    else:
        vb, vw = arrays(1, 7), arrays(2, 3)
        got = golden.dump_edge_fluxes(str(mine), 2, 5, 0, v, vb, vw)
        want = jax_golden.dump_edge_fluxes(str(ref), 2, 5, 0, v, vb, vw)
        assert [p.split("/")[-1] for p in got] == \
            [p.split("/")[-1] for p in want]
        pairs = list(zip(got, want))
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    if writer == "variables":
        got = golden.read_solution(str(mine), 40)
        np.testing.assert_array_equal(
            got, jax_golden.read_solution(str(ref), 40))
        np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("prefix", ["", "out/", "run", "a/b.c", "/abs/x/"])
@pytest.mark.parametrize("m,cycles,level", [(1, 25, 0), (4, 3, 2)])
def test_file_names(prefix, m, cycles, level):
    for name in ("variables", "step_factors", "edge_p"):
        assert golden.output_filepath(prefix, name, m, cycles, level) == \
            jax_golden.output_filepath(prefix, name, m, cycles, level)
        assert golden.solution_filepath(prefix, name, m, cycles, level) == \
            jax_golden.solution_filepath(prefix, name, m, cycles, level)


@pytest.mark.parametrize("noise,rms_scale", [(1e-8, 1.0), (1e-5, 1.0),
                                             (1e-8, 1e-7)])
def test_judge_gives_the_same_dict(noise, rms_scale):
    """judge's verdict, key for key, on seeded legs: accepted, failing
    clause (b), and an RMS at roundoff scale (clause (c) off)."""
    rng = np.random.default_rng(3)
    v64 = 1.0 + rng.standard_normal((200, 5))
    v32 = (v64 * (1 + noise * rng.standard_normal(v64.shape))).astype(
        np.float32)
    rms64 = list(rms_scale * np.array([0.123456, 0.0987654]))
    rms32 = [r * (1 + 1e-7) for r in rms64]
    mine = capacity.judge(v32, rms32, v64, rms64, 2, num_internal_edges=9)
    ref = jax_capacity.judge(v32, rms32, v64, rms64, 2,
                             num_internal_edges=9)
    assert mine == ref


def test_presets_equal():
    assert capacity.PRESETS == jax_capacity.PRESETS


def _leg(pkg, split, out):
    args = ["--preset", "smoke", "--split", split, "--platform", "cpu",
            "--out", str(out)]
    assert pkg.main(args) == 0


def _judge(pkg, fp32, fp64, capsys):
    capsys.readouterr()
    rc = pkg.main(["--preset", "smoke", "--split", "judge",
                   "--fp32", str(fp32), "--fp64", str(fp64)])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_each_package_judges_the_others_legs(tmp_path, capsys):
    """The port's fp32 leg and mgcfd_tpu's fp64 leg (and the other way
    round), each pair judged by both packages: accepted, the same verdict
    but for the device fields, and the npz keys of mgcfd_tpu."""
    legs = {}
    for name, pkg in (("port", capacity), ("jax", jax_capacity)):
        for split in ("leg-fp32", "leg-fp64"):
            legs[name, split] = tmp_path / f"{name}-{split}.npz"
            _leg(pkg, split, legs[name, split])
    for name in ("port", "jax"):
        assert sorted(np.load(legs[name, "leg-fp32"]).files) == \
            ["cycles", "device", "edges", "rms", "v"]
    assert str(np.load(legs["port", "leg-fp32"])["device"]) == "cpu"
    for fp32, fp64 in (("port", "jax"), ("jax", "port")):
        verdicts = []
        for pkg in (capacity, jax_capacity):
            rc, v = _judge(pkg, legs[fp32, "leg-fp32"],
                           legs[fp64, "leg-fp64"], capsys)
            assert rc == 0 and v["accepted"]
            verdicts.append({k: x for k, x in v.items()
                             if not k.endswith("_device")})
        assert verdicts[0] == verdicts[1]


def test_acceptance_in_one_process():
    """Both legs in one process on the CPU: accepted, and within 5e-7 of
    the fp64 oracle."""
    mesh = capacity._build("smoke")
    v = capacity.acceptance(mesh, device="cpu")
    assert v["accepted"] and v["max_rel_fp32_vs_fp64"] < 5e-7
    assert v["num_internal_edges"] == mesh.levels[0].num_internal_edges
