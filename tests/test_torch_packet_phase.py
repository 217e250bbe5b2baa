"""``chip_smoke.py``'s phase 4i, the codec layer and the packet graph, run
whole on the CPU at 320x180, so that its code runs on every test run and
not only on a card whose machine can build the codec.

Every function of the phase runs as the script calls it
(``run_packet_phase``): the toolchain probe, the 96-frame clip, (a)
passthrough, (b) the ``entry()`` chain in packet mode with its wrapped
decode / encode timers and wait conditions, (c) ``configs/rtsp_serving.yaml``
to an in-process RTSP client with the hot switch, and (d) the MP4 CLI in a
subprocess. What differs from the card: the app is built with
``use_cuda=False`` and a 160x96 analysis size, the CLI gets ``--device
cpu``, and, since a wrapper launches no kernel on a CPU tensor, the launch
counts read as the chain's steps (``ProcessingChain.process`` calls).
"""

import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from video_stab_tpu_torch.core import chain as tchain  # noqa: E402
from video_stab_tpu_torch.io import codec as tcodec  # noqa: E402
from video_stab_tpu_torch.io import runner as trunner  # noqa: E402


def _cpu_packet_app(torch, cfg):
    cfg = dataclasses.replace(cfg, stabilizer=dataclasses.replace(
        cfg.stabilizer, analysis_width=160, analysis_height=96))
    app = trunner.StabilizerApp(cfg, use_cuda=False)
    assert app.packet_mode and app.device.type == "cpu", app.device
    return app


def test_phase_4i_runs_whole_on_the_cpu(monkeypatch):
    if not tcodec.available("libx264"):
        pytest.skip("the native codec layer does not build on this host")
    steps = {"n": 0}
    process = tchain.ProcessingChain.process

    def counted(self, frame):
        steps["n"] += 1
        return process(self, frame)

    real_run = chip_smoke.subprocess.run

    def run(cmd, *args, **kw):
        return real_run(["cpu" if a == "cuda" else a for a in cmd], *args,
                        **kw)

    monkeypatch.setattr(tchain.ProcessingChain, "process", counted)
    monkeypatch.setattr(chip_smoke, "APP_H", 180)
    monkeypatch.setattr(chip_smoke, "APP_W", 320)
    monkeypatch.setattr(chip_smoke, "_packet_app", _cpu_packet_app)
    monkeypatch.setattr(chip_smoke, "zero_counts",
                        lambda: steps.update(n=0))
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: {
        k: steps["n"] for k in chip_smoke.PKT_ENTRY_KERNELS})
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "subprocess", types.SimpleNamespace(
        run=run, PIPE=chip_smoke.subprocess.PIPE))

    numbers, by_run, frames = chip_smoke.run_packet_phase(torch)

    assert numbers["available"] and not numbers["toolchain"]["missing"]
    assert numbers["passthrough"]["byte_identical"]
    assert numbers["processing"]["output_format"] == "i420"
    assert numbers["rtsp_serving"]["frames_received"] >= \
        chip_smoke.PKT_RTSP_MIN_FRAMES
    assert numbers["cli"]["codec"] == "h264"
    assert set(by_run) == set(frames) == {
        "packets entry() 1080p", "packets rtsp_serving 1080p"}
    assert all(n > 0 for n in frames.values())
