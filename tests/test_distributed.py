"""Multi-host glue exercised single-process on the 8-virtual-device mesh."""
import jax
import jax.numpy as jnp
import numpy as np

from roadsurf_tpu.parallel.distributed import (gather_to_host, global_points_mesh,
                                               host_point_range, make_global)
from roadsurf_tpu.parallel.sharding import POINTS


def test_host_point_range_single_process():
    s, e = host_point_range(1000)
    assert (s, e) == (0, 1000)


def test_make_global_sharded():
    mesh = global_points_mesh()
    x = np.arange(64, dtype=np.float32)
    tree = {"a": x, "b": x.reshape(64, 1), "scalar": np.float32(3.0)}
    g = make_global(tree, mesh)
    assert not g["a"].sharding.is_fully_replicated
    assert g["scalar"].sharding.is_fully_replicated
    np.testing.assert_array_equal(gather_to_host(g["a"]), x)
    # computation over the sharded tree works transparently
    y = jax.jit(lambda t: t["a"] * 2 + t["b"][:, 0])(g)
    np.testing.assert_array_equal(np.asarray(y), x * 3)


def test_multiprocess_scan_parity():
    """SURVEY section 4(c): N local processes, per-host point-range loading,
    make_array_from_process_local_data assembly, SPMD scan == per-host
    single-process result (tests/_mp_worker.py)."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    worker = os.path.join(os.path.dirname(__file__), "_mp_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = dict(os.environ)
    env["PYTHONPATH"] = (env.get("PYTHONPATH", "") + os.pathsep + repo
                         ).lstrip(os.pathsep)
    nproc = 2
    import tempfile
    shard_dir = tempfile.mkdtemp(prefix="rs_shards_")
    env["MP_SHARD_DIR"] = shard_dir
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(nproc), str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"MP_OK {i}" in out, f"worker {i} output:\n{out}"


def test_multiprocess_runner_shards(tmp_path):
    """The runner CLI's multi-host branch end to end:
    2 real processes drive ``runner.run`` on the example2 operational config
    (NWP grid + ASCII station obs, COUPLED) -- each writes its output shard
    + per-shard checkpoint (runner.py drain='shard' branch); the shards are
    then merged through the ``merge-shards`` CLI subcommand and compared
    against a single-process reference run of the same config."""
    import importlib.util
    import json
    import os
    import socket
    import subprocess
    import sys

    import jax as _jax
    if _jax.process_count() != 1:
        import pytest
        pytest.skip("parent must be single-process")

    ex2 = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "example2")
    spec = importlib.util.spec_from_file_location(
        "ex2_gen", os.path.join(ex2, "make_data.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    gen.main(["--analysis", "2", "--forecast", "2", "--ny", "6", "--nx", "8",
              "--outdir", str(tmp_path)])

    from roadsurf_tpu.io.sources import read_json_tolerant
    cfg = read_json_tolerant(os.path.join(ex2, "grid_config.json"))
    cfg["time"]["analysis"] = 1
    cfg["time"]["forecast"] = 1
    cfg["model"]["DTSecs"] = 120
    cfg["model"]["use_coupling"] = 1          # the operational coupled mode
    cfg["points"]["grid"]["ny"] = 6
    cfg["points"]["grid"]["nx"] = 8
    cfg["points"]["mask"] = {"path": str(tmp_path / "road_mask.txt"),
                             "include": "1"}
    cfg["input"][0]["path"] = str(tmp_path / "forecast_grid.npz")
    cfg["input"][1]["path"] = str(tmp_path / "road_station.txt")
    cfg["output"]["filename"] = str(tmp_path / "unused.npz")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))

    from roadsurf_tpu import runner
    _, ref_fields = runner.run(str(cfg_path), "20191202T0000",
                               output_path=str(tmp_path / "ref.npz"),
                               verbose=False, engine="pallas")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = os.path.join(os.path.dirname(__file__), "_mp_runner_worker.py")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(worker)))
    env = dict(os.environ)
    env["PYTHONPATH"] = (env.get("PYTHONPATH", "") + os.pathsep + repo
                         ).lstrip(os.pathsep)
    out_base = str(tmp_path / "mp_out.npz")
    env["MP_RUN_CFG"] = str(cfg_path)
    env["MP_RUN_OUT"] = out_base
    env["MP_RUN_CK"] = str(tmp_path / "mp_ck.npz")
    env["MP_RUN_T"] = "20191202T0000"
    nproc = 2
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(nproc), str(i)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"runner worker {i} failed:\n{out}"
        assert f"MP_RUNNER_OK {i}" in out, f"worker {i} output:\n{out}"

    shards = sorted(str(f) for f in tmp_path.glob("mp_out.npz.shard*.npz"))
    assert len(shards) == nproc, shards
    merged = tmp_path / "merged.npz"
    runner.main(["merge-shards", str(merged)] + shards)
    z = np.load(merged)
    np.testing.assert_array_equal(z["steps"], ref_fields["steps"])
    for n in ("tsurf", "wat", "snow", "ice", "ice2", "dep"):
        np.testing.assert_allclose(z[n], ref_fields[n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    # per-shard checkpoints written (warm-start entry points per host)
    cks = sorted(tmp_path.glob("mp_ck.npz.shard*"))
    assert len(cks) == nproc, cks


def test_salt_melt_switches_config():
    from roadsurf_tpu.config import ModelSettings
    s = ModelSettings.from_json({"model": {"force_snow_melting": 1,
                                           "use_relaxation": 1}})
    assert s.force_snow_melting and not s.force_ice_melting
    assert s.use_relaxation
