"""The port's C++ host solvers (`cook_tpu_torch/ops/native.py`) on the CPU.

- The 3 + 6 + 5 cases of tests/test_native.py, the port's binding held
  with the reference's assertions against the port's numpy oracles
  (`cook_tpu_torch.ops.cpu_reference`) and against the reference's
  (`cook_tpu.ops.cpu_reference`): `ORACLE` over `port` / `ref`.
- Across the packages: the port's library and the reference's
  (`cook_tpu.ops.native`, built by `make -C native`) give equal answers
  on the same inputs.
- The build: `_build/libcook_native.so`, never `native/`; rebuilt when
  the source is newer; a failed build raises with the compiler's output
  (these tests then fail: nothing here skips).
"""
import os
import stat

import numpy as np
import pytest

from cook_tpu.ops import cpu_reference as ref_oracle
from cook_tpu_torch import build
from cook_tpu_torch.ops import cpu_reference as port_oracle
from cook_tpu_torch.ops import native
from tests.test_ops_parity import (
    random_dru_problem,
    random_match_problem,
    random_rebalance_problem,
)

ORACLE = pytest.mark.parametrize("ref", [port_oracle, ref_oracle],
                                 ids=["port", "ref"])


@ORACLE
@pytest.mark.parametrize("seed", range(3))
def test_native_greedy_match_parity(ref, seed):
    rng = np.random.default_rng(seed)
    demands, avail, totals, feasible = random_match_problem(rng)
    want = ref.ref_greedy_match(demands, avail, totals, feasible)
    got = native.greedy_match(demands, avail, totals, feasible)
    np.testing.assert_array_equal(got, want)
    # and without a mask
    np.testing.assert_array_equal(
        native.greedy_match(demands, avail, totals),
        ref.ref_greedy_match(demands, avail, totals),
    )


@ORACLE
@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("gpu_mode", [False, True])
def test_native_dru_parity(ref, seed, gpu_mode):
    rng = np.random.default_rng(seed)
    user, mem, cpus, gpus, order_key, md, cd, gd = random_dru_problem(rng)
    want_dru, want_order = ref.ref_dru_order(
        user, mem, cpus, gpus, order_key, md, cd, gd, gpu_mode=gpu_mode
    )
    got_dru, got_order = native.dru_rank(
        user, mem, cpus, gpus, order_key, md, cd, gd, gpu_mode=gpu_mode
    )
    np.testing.assert_allclose(got_dru, want_dru, rtol=1e-12)
    np.testing.assert_array_equal(got_order, want_order)


@ORACLE
@pytest.mark.parametrize("seed", range(5))
def test_native_preemption_parity(ref, seed):
    rng = np.random.default_rng(300 + seed)
    task_host, task_dru, task_res, eligible, spare, host_ok = (
        random_rebalance_problem(rng)
    )
    demand = (400.0, 6.0, 0.0)
    want = ref.ref_preemption_decision(
        task_host, task_dru, task_res[:, 0], task_res[:, 1], task_res[:, 2],
        eligible, spare, host_ok, demand, 0.4, 1.0, 0.5,
    )
    got = native.find_preemption(
        task_host, task_dru, task_res, eligible, spare, host_ok,
        np.asarray(demand), 0.4, 1.0, 0.5,
    )
    if want is None:
        assert got is None
        return
    want_host, want_tasks = want
    got_host, got_tasks = got
    if not want_tasks:
        # spare-only: any spare-fitting host acceptable; check it fits
        assert got_tasks == []
        assert np.all(spare[got_host] >= np.asarray(demand))
    else:
        assert got_host == want_host
        assert sorted(got_tasks) == sorted(want_tasks)


# ------------------------------------------------------ across the packages


@pytest.fixture(scope="module")
def ref_native():
    from cook_tpu.ops import native as ref_native

    assert ref_native.available(), "make -C native failed"
    return ref_native


@pytest.mark.parametrize("seed", range(4))
def test_port_and_reference_libraries_agree(ref_native, seed):
    rng = np.random.default_rng(1000 + seed)
    # a larger draw than the parity cases: many equal fits on equal hosts
    demands, avail, totals, feasible = random_match_problem(rng, j=600,
                                                            n=90)
    avail[::3] = avail[0]
    totals[::3] = totals[0]
    for mask in (feasible, None):
        np.testing.assert_array_equal(
            native.greedy_match(demands, avail, totals, mask),
            ref_native.greedy_match(demands, avail, totals, mask))
    problem = random_dru_problem(rng, t=2000, u=17)
    for gpu_mode in (False, True):
        got = native.dru_rank(*problem, gpu_mode=gpu_mode)
        want = ref_native.dru_rank(*problem, gpu_mode=gpu_mode)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    task_host, task_dru, task_res, eligible, spare, host_ok = (
        random_rebalance_problem(rng, t=3000, h=200))
    for demand in ((400.0, 6.0, 0.0), (50.0, 0.5, 0.0), (9e9, 1.0, 0.0)):
        args = (task_host, task_dru, task_res, eligible, spare, host_ok,
                np.asarray(demand), 0.4, 1.0, 0.5)
        assert native.find_preemption(*args) == \
            ref_native.find_preemption(*args)


# ------------------------------------------------------------------ build


def test_library_builds_into_the_package_build_dir_not_native():
    assert native.available()
    lib = build.native_path()
    assert os.path.dirname(lib) == build.BUILD_DIR
    assert os.path.getmtime(lib) >= os.path.getmtime(build.NATIVE_SRC)


@pytest.fixture
def scratch_build(tmp_path, monkeypatch):
    src = tmp_path / "cook_native.cc"
    with open(build.NATIVE_SRC) as f:
        src.write_text(f.read())
    monkeypatch.setattr(build, "NATIVE_SRC", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(build, "_libs", {})
    return src


def test_a_stale_library_is_rebuilt(scratch_build, monkeypatch, tmp_path):
    log = tmp_path / "calls"
    real = build.shutil.which("g++")
    wrapper = tmp_path / "g++"
    wrapper.write_text(f"#!/bin/sh\necho x >> {log}\nexec {real} \"$@\"\n")
    wrapper.chmod(wrapper.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    build.load_native()
    build._libs.clear()
    build.load_native()  # up to date: no second compile
    assert log.read_text().count("x") == 1
    os.utime(build.native_path(), (100, 100))
    build._libs.clear()
    build.load_native()
    assert log.read_text().count("x") == 2
    assert not [n for n in os.listdir(build.BUILD_DIR) if n.endswith(".tmp")]


def test_a_failed_build_raises_with_the_compiler_output(scratch_build):
    scratch_build.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for "
                                           "native/cook_native.cc"):
        build.load_native()
    assert not os.path.exists(build.native_path())


def test_chip_smoke_native_parity_on_cpu():
    """chip_smoke.py's N1 checks, which need no card: the native solvers
    identical to the port's cpu_reference at the CPU tests' seeds and at
    bench.py's CPU sizing (16,000 x 2,000)."""
    import chip_smoke

    chip_smoke.native_parity()


@ORACLE
def test_float32_columns_make_the_oracle_sum_in_float32(ref):
    """Found holding the native solvers to the oracles at bench.py's
    sizing, whose columns are float32: `ref_dru_order` (both packages')
    sums in its inputs' dtype, since numpy keeps float32 plus a Python
    float in float32, while the native solver sums in float64 whatever it
    is given.  On float64 columns (the parity cases) the two agree."""
    rng = np.random.default_rng(3)
    user, mem, cpus, gpus, order_key, md, cd, gd = random_dru_problem(
        rng, t=4000, u=5)
    cols32 = [np.asarray(a, np.float32) for a in (mem, cpus, gpus)]
    divs32 = [np.asarray(a, np.float32) for a in (md, cd, gd)]
    dru32, _ = ref.ref_dru_order(user, *cols32, order_key, *divs32)
    dru64, _ = ref.ref_dru_order(
        user, *(a.astype(np.float64) for a in cols32), order_key,
        *(a.astype(np.float64) for a in divs32))
    got, _ = native.dru_rank(user, *cols32, order_key, *divs32)
    np.testing.assert_array_equal(got, dru64)
    assert not np.array_equal(dru32, dru64)
