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

import numpy as np
import pytest
import torch

from benchmark_torch import harness, peaks
from benchmark_torch.harness import HERE, Window, drive, load_module

ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"chain_1080p": "benchmark_torch/tests/chain_small.json",
         "multicam_8x1080p": "benchmark_torch/tests/multicam_small.json"}


def small_manifest() -> dict:
    """The manifest with each configuration at a size the CPU holds."""
    m = json.loads(json.dumps(MANIFEST))
    for c in m["configs"]:
        c["file"] = SMALL[c["name"]]
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
    the unchanged harness: one configuration of the chain, and one of a
    new system held to a new reference, which decides ``correct``."""
    bench = tmp_path / "bench"
    for d in ("traffic", "systems", "metrics", "end_to_end", "reference"):
        shutil.copytree(HERE / d, bench / d,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "systems" / "lag.py").write_text(LAG_SYSTEM)
    (bench / "reference" / "lag.py").write_text(LAG_REFERENCE)
    cfg = json.loads((HERE / "tests" / "chain_small.json").read_text())
    cfg["stabilizer"]["max_corners"] = 48
    (tmp_path / "throwaway.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "cam15.json").write_text(json.dumps(
        {"loop": "open", "rate_per_s": 15, "sample_every": 4,
         "traced_calls": 4}))
    (bench / "metrics" / "calls_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.tracer.active)\n")
    m = small_manifest()
    m["configs"].append({"name": "throwaway", "source": "a test",
                         "file": str(tmp_path / "throwaway.json"),
                         "reduced": [], "why": "a test"})
    m["workloads"].append({"name": "throwaway.cam15", "config": "throwaway",
                           "traffic": "cam15", "chips": 1, "why": "a test"})
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
