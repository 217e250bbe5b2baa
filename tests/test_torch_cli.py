"""The PyTorch port's command-line interface (``cli.py``) on the CPU:
``main([...])`` with ``--device cpu`` for ``selftest``, ``stabilize`` and
``offline --method box`` on a tiny .avi, ``stabilize`` from an MP4 to an
MP4, ``run`` on a small YAML, ``run --packet on`` on an .h264 source and
``profile``; the commands not ported yet exit non-zero naming their
ROADMAP items."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
cv2 = pytest.importorskip("cv2")

from video_stab_tpu_torch import cli  # noqa: E402
from video_stab_tpu_torch.utils import config as tconfig  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _last_json(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 20-frame 64x96 .avi of a jittering textured window."""
    path = str(tmp_path_factory.mktemp("cli") / "in.avi")
    rng = np.random.default_rng(0)
    world = cv2.GaussianBlur(rng.random((96, 128)).astype(np.float32),
                             (0, 0), 2.0)
    world = ((world - world.min()) / np.ptp(world) * 255).astype(np.uint8)
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                        (96, 64))
    for _ in range(20):
        dx, dy = rng.integers(0, 16, 2)
        w.write(cv2.cvtColor(world[dy:dy + 64, dx:dx + 96],
                             cv2.COLOR_GRAY2BGR))
    w.release()
    return path


def test_selftest(capsys):
    assert cli.main(["selftest", "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out == {"selftest": "ok", "frames_out": 16, "device": "cpu"}


def test_stabilize(clip, tmp_path, capsys):
    dst = str(tmp_path / "out.avi")
    assert cli.main(["stabilize", clip, dst, "--radius", "4",
                     "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["frames_in"] == out["frames_out"] == 20
    cap = cv2.VideoCapture(dst)
    ok, frame = cap.read()
    cap.release()
    assert ok and frame.shape == (64, 96, 3)


def test_stabilize_mp4_to_mp4(clip, tmp_path, capsys):
    """``stabilize in.mp4 out.mp4``: the output goes through ContainerSink
    (native H.264 encode + MP4 mux) and demuxes as H.264."""
    from video_stab_tpu_torch.io import codec as tcodec

    if not tcodec.available():
        pytest.skip("native codec layer unavailable")
    src, dst = str(tmp_path / "in.mp4"), str(tmp_path / "out.mp4")
    cap = cv2.VideoCapture(clip)
    w = tcodec.ContainerWriter(src, 96, 64, 30.0)
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        w.write(frame)
    cap.release()
    w.close()
    assert cli.main(["stabilize", src, dst, "--radius", "4",
                     "--device", "cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["frames_in"] == out["frames_out"] == 20
    dm = tcodec.ContainerDemuxer(dst)
    assert dm.codec_name == "h264"
    dec = tcodec.VideoDecoder()
    frames = []
    while (pkt := dm.read()) is not None:
        frames += dec.decode(pkt)
    frames += dec.flush()
    dm.close()
    dec.close()
    assert len(frames) == 20 and frames[0].shape == (64, 96, 3)


def test_offline_box(clip, tmp_path, capsys):
    dst = str(tmp_path / "off.avi")
    assert cli.main(["offline", clip, dst, "--method", "box", "--radius",
                     "4", "--device", "cpu"]) == 0
    assert _last_json(capsys.readouterr().out)["frames"] == 20
    assert os.path.getsize(dst) > 0


def test_run_small_config(tmp_path, capsys):
    cfg = tconfig.load_config(os.path.join(REPO, "configs", "selftest.yaml"))
    cfg = tconfig.AppConfig(
        video_source="synthetic:128x96", mode=cfg.mode, enhancer=cfg.enhancer,
        stabilizer=tconfig.StabilizerParams(
            smoothing_radius=4, analysis_width=64, analysis_height=48,
            max_corners=32, ransac_hypotheses=32))
    path = str(tmp_path / "small.yaml")
    tconfig.save_config(cfg, path)
    assert cli.main(["run", path, "--frames", "4", "--duration", "60",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out
    snap = json.loads(out[out.index("{"):])
    assert snap["counters"]["frames_out"] >= 4


def test_profile_writes_a_trace(tmp_path, capsys):
    assert cli.main(["profile", "--device", "cpu", "--frames", "2",
                     "--width", "128", "--height", "96", "--logdir",
                     str(tmp_path)]) == 0
    out = _last_json(capsys.readouterr().out)
    assert os.path.getsize(out["trace"]) > 0


@pytest.mark.parametrize("argv,item", [
    (["bench"], "item 1"),
    (["train-detector", "--steps", "3"], "item 12b"),
    (["train-deepstab", "--out", "x.msgpack"], "item 12b"),
])
def test_not_ported_commands_fail_loudly(argv, item, capsys):
    assert cli.main(argv) != 0
    assert item in capsys.readouterr().err


def test_run_packet_on_an_h264_source(tmp_path, capsys):
    """``run --packet on``: the compressed-domain graph decodes the .h264
    source, stabilizes on the CPU and re-encodes a decodable .h264."""
    from video_stab_tpu_torch.io import codec as tcodec

    if not tcodec.available():
        pytest.skip("native codec layer unavailable")
    src, dst = str(tmp_path / "in.h264"), str(tmp_path / "out.h264")
    rng = np.random.default_rng(1)
    enc = tcodec.VideoEncoder(128, 96, 30, bitrate_bps=400_000, gop=12)
    with open(src, "wb") as f:
        for _ in range(24):
            f.write(enc.encode(rng.integers(0, 255, (96, 128, 3),
                                            dtype=np.uint8)))
        f.write(enc.flush())
    enc.close()
    cfg = tconfig.load_config(os.path.join(REPO, "configs", "selftest.yaml"))
    cfg = tconfig.AppConfig(
        video_source=src, output_source=dst, mode=cfg.mode,
        enhancer=cfg.enhancer,
        stabilizer=tconfig.StabilizerParams(
            smoothing_radius=4, analysis_width=64, analysis_height=48,
            max_corners=32, ransac_hypotheses=32))
    path = str(tmp_path / "packet.yaml")
    tconfig.save_config(cfg, path)
    assert cli.main(["run", path, "--packet", "on", "--frames", "8",
                     "--duration", "60", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "packet_mode=True" in out
    snap = json.loads(out[out.index("{"):])
    assert snap["counters"]["frames_out"] >= 8
    dec = tcodec.VideoDecoder()
    with open(dst, "rb") as f:
        frames = dec.decode(f.read()) + dec.flush()
    dec.close()
    assert frames and all(fr.shape == (96, 128, 3) for fr in frames)
