"""The benchmark's harness on the CPU: every name of BENCHMARK.json
resolves to its files, the open loop's latency and the closed loop's rate
are the arithmetic they claim, the kernels' work at 1080p is the hand
count, a run without a card exits non-zero, and a new configuration, mix
and metric need only new files.

    python -m pytest benchmark_torch/tests -q
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark_torch import harness, peaks
from benchmark_torch.harness import HERE, Window, drive, load_module

ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL_DIR = HERE / "tests"
# The keys a configuration's small copy may change: its sizes.
SIZES = {"source", "assumed", "height", "width", "streams", "pool_frames"}
STAGE_SIZES = {"stabilizer": {"smoothing_radius", "max_corners",
                              "analysis_width", "analysis_height",
                              "ransac_hypotheses"}}


def small_manifest(manifest: dict = MANIFEST,
                   small_dir: Path = SMALL_DIR) -> dict:
    """The manifest with each configuration at a size the CPU holds: its
    copy ``<small_dir>/<config>_small.json``."""
    m = json.loads(json.dumps(manifest))
    for c in m["configs"]:
        c["file"] = str(small_dir / f"{c['name']}_small.json")
    return m


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = harness.resolve(MANIFEST, cell, ROOT)
    assert (HERE / "systems" / f"{c.config['system']}.py").is_file()
    reference = harness.load_reference(c.config)
    reference.check(c.config)
    assert callable(reference.outputs)
    assert c.traffic["loop"] in ("open", "closed")
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    for m in c.end_to_end:
        assert hasattr(load_module(HERE / "end_to_end" / f"{m['name']}.py"),
                       "read")
    assert c.per_layer
    for m in c.per_layer:
        assert hasattr(load_module(HERE / "metrics" / f"{m['name']}.py"),
                       "read")
    for path in (HERE / "work").glob("*.py"):
        mod = load_module(path)
        assert isinstance(mod.SYMBOL, str)
        mod.launches(c.config)


def test_config_files_are_the_manifests():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        assert f.startswith(MANIFEST["paths"][0] + "/")
        cfg = json.loads((ROOT / f).read_text())
        assert {"system", "reference", "height", "width", "streams",
                "pool_frames", "correct_limits"} <= set(cfg)
        assert (HERE / "reference" / f"{cfg['reference']}.py").is_file()


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_every_config_has_a_small_copy_that_differs_only_in_size(config):
    """A configuration's CPU-size copy runs the same system against the
    same reference and limits, with the same stages and settings; only
    its sizes are cut."""
    entry = {c["name"]: c for c in MANIFEST["configs"]}[config]
    full = json.loads((ROOT / entry["file"]).read_text())
    small_file = SMALL_DIR / f"{config}_small.json"
    assert small_file.is_file(), f"{config} has no {small_file.name}"
    small = json.loads(small_file.read_text())
    assert set(small) == set(full)
    for key in set(full) - SIZES:
        if not isinstance(full[key], dict) or key == "correct_limits":
            assert small[key] == full[key], key
            continue
        assert set(small[key]) == set(full[key]), key
        for k in set(full[key]) - STAGE_SIZES.get(key, set()):
            assert small[key][k] == full[key][k], (key, k)
    harness.load_reference(small).check(small)


@pytest.mark.parametrize("change", [
    ("stabilizer", "motion_model", "homography"),
    ("stabilizer", "redetect_interval", 3),
    ("stabilizer", "smoothing_method", "gaussian"),
    ("roll", "canny_aperture", 5),
    ("enhancer", "enable_unsharp", True),
    (None, "detector", {"model": "centernet"}),
    (None, "system", "offline"),
], ids=lambda c: c[1])
def test_stream_reference_refuses_what_it_does_not_model(change):
    """A configuration that asks the stream reference for another
    pipeline raises, rather than being compared against this one."""
    cfg = json.loads((HERE / "configs" / "chain_1080p.json").read_text())
    reference = harness.load_reference(cfg)
    reference.check(cfg)
    group, key, value = change
    (cfg if group is None else cfg[group])[key] = value
    with pytest.raises(ValueError):
        reference.check(cfg)
    pool = torch.zeros((2, 1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError):
        reference.outputs(cfg, pool, 40, 5, [20])


@pytest.mark.parametrize("change", [
    ("stabilizer", "motion_model", "similarity"),
    ("stabilizer", "redetect_interval", 3),
    ("stabilizer", "smoothing_method", "gaussian"),
    ("roll", "canny_aperture", 5),
    ("enhancer", "enable_unsharp", True),
    (None, "streams", 2),
    (None, "system", "multistream"),
    (None, "roll", None),
], ids=lambda c: f"{c[1]}={c[2]}")
def test_homography_reference_refuses_what_it_does_not_model(change):
    """The homography reference models the one-camera chain with its
    enhancer and two-pass roll, re-detecting every 2nd frame."""
    cfg = json.loads((HERE / "configs" /
                      "chain_homography_1080p.json").read_text())
    reference = harness.load_reference(cfg)
    reference.check(cfg)
    group, key, value = change
    if value is None:
        del cfg[key]
    else:
        (cfg if group is None else cfg[group])[key] = value
    with pytest.raises(ValueError):
        reference.check(cfg)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        assert s > 0
        self.t += s


class FakeSystem:
    """Each call takes ``durations[i]`` seconds of the fake clock and
    delivers ``streams`` frames, or nothing where ``fail`` holds i."""

    def __init__(self, clock, durations, streams=1, fail=()):
        self.clock, self.durations = clock, durations
        self.streams, self.fail = streams, set(fail)
        self.calls = []

    def call(self, i):
        self.calls.append(i)
        self.clock.t += self.durations(i)
        if i in self.fail:
            return None
        return np.zeros((self.streams, 2, 2, 3), np.uint8)


def test_open_loop_counts_a_stall_against_every_later_frame():
    clock = FakeClock()
    stall = 7                       # the call that takes 200 ms
    system = FakeSystem(clock, lambda i: 0.2 if i == stall else 0.01)
    traffic = {"loop": "open", "rate_per_s": 30}
    w = Window()
    drive(system, traffic, w, 1.0, set(), clock=clock, sleep=clock.sleep)
    assert w.calls == 30 and system.calls == list(range(30))
    # The model: a call starts when it is due or when the last one
    # returned, whichever is later; its latency runs from its due time.
    want, end = [], 100.0
    for i in range(30):
        due = 100.0 + i / 30
        end = max(due, end) + (0.2 if i == stall else 0.01)
        want.append(end - due)
    assert w.latencies_s == pytest.approx(want, abs=1e-9)
    delayed = [x for x in w.latencies_s[stall + 1:] if x > 0.0101]
    assert len(delayed) == 8        # 190 ms of backlog drains at 23.3 ms
    assert w.latencies_s[stall + 1] == pytest.approx(0.2 + 0.01 - 1 / 30)
    for q in (50, 95):
        reader = load_module(HERE / "end_to_end" / f"frame_latency_p{q}_ms.py")
        assert reader.read(w) == pytest.approx(np.percentile(want, q) * 1e3)


def test_frames_per_s_is_every_frame_over_the_whole_window():
    clock = FakeClock()
    system = FakeSystem(clock, lambda i: 0.025, streams=8, fail={5})
    w = Window(frames_per_call=8)
    drive(system, {"loop": "closed"}, w, 1.0, set(), clock=clock,
          sleep=clock.sleep)
    assert w.calls == 40 and w.failed_calls == 1
    assert w.elapsed_s == pytest.approx(1.0)
    fps = load_module(HERE / "end_to_end" / "frames_per_s.py")
    assert fps.read(w) == pytest.approx(39 * 8 / 1.0)


def test_work_matches_hand_counts_at_1080p():
    chain = json.loads((HERE / "configs" / "chain_1080p.json").read_text())
    multi = json.loads((HERE / "configs" /
                        "multicam_8x1080p.json").read_text())

    def work(kernel, cfg):
        return load_module(HERE / "work" / f"{kernel}.py").launches(cfg)

    # K1: the 1080p emit (read + write of 3 channels, 37 ops a pixel) and
    # the 540x960 gray rotation (19 ops a pixel); 8 emits in one launch.
    assert work("warp_affine_u8", chain) == [
        (2 * 1080 * 1920 * 3, 1080 * 1920 * 37),
        (2 * 540 * 960, 540 * 960 * 19)]
    assert work("warp_affine_u8", multi) == [
        (8 * 12_441_600, 8 * 76_723_200)]
    assert work("warp_homography_u8", chain) == []
    assert work("corner_response", chain) == [(4_665_600, 28_512_000)]
    assert work("corner_response", multi) == [(8 * 4_665_600,
                                               8 * 28_512_000)]
    assert work("enhance_u8", chain) == [(20_736_000, 60_134_400)]
    assert work("enhance_u8", multi) == []
    # K6: 200 points, 3 levels, a 16 x 16 footprint in 4 float32 planes.
    assert work("lk_track", chain) == [(200 * 12_310, 225 * 200 * 3 * 33)]
    assert peaks.least_us(20_736_000, 60_134_400) == pytest.approx(6.19,
                                                                   abs=5e-3)
    assert peaks.least_us(2_462_000, 4_455_000) == pytest.approx(0.735,
                                                                 abs=5e-4)


def test_homography_work_lists_the_roll_rotation_beside_the_emit():
    """With the homography model the chain's ``warp_tile_kernel`` launches
    are K2's emit (42 ops a pixel, ``warp_homography_u8``) and the two-pass
    roll's whole-frame K1 rotation (37, ``warp_affine_u8``), 12,441,600
    bytes each at 1080p; the similarity cells list no K2 launch."""
    def work(kernel, name):
        cfg = json.loads((HERE / "configs" / f"{name}.json").read_text())
        return load_module(HERE / "work" / f"{kernel}.py").launches(cfg)

    assert work("warp_homography_u8", "chain_homography_1080p") == [
        (12_441_600, 2_073_600 * 42)]
    assert work("warp_affine_u8", "chain_homography_1080p") == [
        (12_441_600, 2_073_600 * 37)]
    assert work("warp_homography_u8", "chain_1080p") == []
    assert work("warp_homography_u8", "multicam_8x1080p") == []


def test_roofline_takes_a_shared_symbols_launches_once():
    """K1 and K2 are one symbol: its recorded launches and time count
    once, against the mean least time of what both work files list."""
    from benchmark_torch import readings

    class Trace:
        asked = []

        def kernel_time(self, symbol):
            self.asked.append(symbol)
            return (4, 100.0) if symbol == "warp_tile_kernel" else (0, 0.0)

    cfg = json.loads((HERE / "configs" /
                      "chain_homography_1080p.json").read_text())
    ctx = type("Ctx", (), {"trace": Trace(), "cfg": cfg})()
    got = readings.kernel_roofline_share(ctx)
    least = (peaks.least_us(12_441_600, 2_073_600 * 42)
             + peaks.least_us(12_441_600, 2_073_600 * 37)) / 2
    assert got == pytest.approx(100.0 * 4 * least / 100.0)
    assert Trace.asked.count("warp_tile_kernel") == 1


def test_no_file_of_the_benchmark_imports_jax():
    """The harness, its references and its tests run without JAX and the
    JAX package: no ``import`` of theirs names one, by whole top-level
    name (the port's ``video_stab_tpu_torch`` begins with the JAX
    package's name)."""
    import ast
    from benchmark_torch import run
    found = []
    for path in sorted(HERE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in run.FORBIDDEN]
    assert found == []


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark_torch import run
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "video_stab_tpu_torch_x", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "video_stab_tpu.core", object())
    assert run.forbidden_modules() == ["jax", "video_stab_tpu"]


def test_run_without_a_card_exits_nonzero(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, and with no CUDA device: no result, a nonzero exit."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark_torch.run", "--workload",
         "chain_1080p.saturated", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    if not torch.cuda.is_available():
        assert "CUDA" in proc.stderr


LAG_SYSTEM = """
import torch


class System:
    \"\"\"Delivers the pool's frame of ``lag`` calls ago.\"\"\"

    def __init__(self, cfg, pool, seed, device):
        self.pool, self.lead = pool, cfg["lag"]

    def call(self, i):
        if i < self.lead:
            return None
        return self.pool[(i - self.lead) % len(self.pool)].copy()

    def close(self):
        self.pool = None
"""

LAG_REFERENCE = """
def outputs(cfg, pool, n_calls, seed, calls, precision=None):
    return {c: pool[(c - cfg["reference_lag"]) % pool.shape[0]]
            for c in calls}
"""


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    """Throwaway configurations, a traffic mix, a system, a reference and
    a per-layer metric, added as files and manifest entries, run through
    the unchanged harness: one configuration of the chain, which enters
    the CPU tests through ``small_manifest`` by its small copy's name
    beside the manifest's own, and one of a new system held to a new
    reference, which decides ``correct``."""
    bench = tmp_path / "bench"
    for d in ("traffic", "systems", "metrics", "end_to_end", "reference"):
        shutil.copytree(HERE / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "systems" / "lag.py").write_text(LAG_SYSTEM)
    (bench / "reference" / "lag.py").write_text(LAG_REFERENCE)
    small_dir = tmp_path / "tests"
    shutil.copytree(SMALL_DIR, small_dir,
                    ignore=shutil.ignore_patterns("*.py", "__pycache__"))
    for src, dst in ((HERE / "configs" / "chain_1080p.json",
                      tmp_path / "throwaway.json"),
                     (SMALL_DIR / "chain_1080p_small.json",
                      small_dir / "throwaway_small.json")):
        cfg = json.loads(src.read_text())
        cfg["stabilizer"]["max_corners"] = 48
        dst.write_text(json.dumps(cfg))
    (bench / "traffic" / "cam15.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 15, "sample_every": 4,
         "traced_calls": 4}))
    (bench / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.tracer.active)\n")
    m = json.loads(json.dumps(MANIFEST))
    m["configs"].append({"name": "throwaway", "source": "a test",
                         "file": str(tmp_path / "throwaway.json"),
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "throwaway.cam15", "config": "throwaway",
                           "traffic": "cam15", "chips": 1, "why": "a test"})
    m = small_manifest(m, small_dir)
    assert len(m["configs"]) == len(MANIFEST["configs"]) + 1
    assert m["configs"][-1]["file"] == str(small_dir / "throwaway_small.json")
    m["per_layer"].append({"name": "calls_traced", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "setup_s",
                           "workloads": ["throwaway.cam15"]})
    res = harness.run(m, ROOT, "throwaway.cam15", 3, 0.5, True,
                      torch.device("cpu"), bench=bench)
    assert res["correct"]
    assert res["metrics"] == {"calls_traced": {"value": 4.0,
                                               "unit": "calls"}}

    lagged = {"system": "lag", "reference": "lag", "height": 24,
              "width": 32, "streams": 2, "pool_frames": 5, "lag": 3,
              "reference_lag": 3,
              "correct_limits": {"frame_mad_max": 0.25,
                                 "frame_off2_max": 1.0}}
    for name, ref_lag in (("lagged", 3), ("lagged_wrong", 2)):
        (tmp_path / f"{name}.json").write_text(json.dumps(
            dict(lagged, reference_lag=ref_lag)))
        m["configs"].append({"name": name, "source": "a test",
                             "file": str(tmp_path / f"{name}.json"),
                             "reduced": [], "why": "a test"})
        m["workloads"].append({"name": f"{name}.cam15", "config": name,
                               "traffic": "cam15", "chips": 1,
                               "why": "a test"})
    m["per_layer"][-1]["workloads"] += ["lagged.cam15", "lagged_wrong.cam15"]
    res = harness.run(m, ROOT, "lagged.cam15", 4, 0.5, True,
                      torch.device("cpu"), bench=bench)
    assert res["correct"], res["checks"]
    assert res["checks"]["frame_mad_max"]["value"] == 0.0
    assert res["metrics"] == {"calls_traced": {"value": 4.0,
                                               "unit": "calls"}}
    res = harness.run(m, ROOT, "lagged_wrong.cam15", 4, 0.5, False,
                      torch.device("cpu"), bench=bench)
    assert not res["correct"], res["checks"]
