"""The PyTorch port's YAML config loader (``utils/config.py``) and REST
update (``io/control.py:apply_rest_update``) against the JAX package's.

Held: every shipped ``configs/*.yaml`` parses to the same values field for
field (``dataclasses.asdict`` of each section), as does a text with the
reference's quirks (the ``gausian`` spelling, enum-int fields, camelCase
``fadeAlpha``, the roi as four keys, unknown keys); ``save_config`` writes
the same file as the JAX package's and round-trips; ``apply_rest_update``
rewrites a config to the same bytes; ``ConfigWatcher`` fires on a rewrite.
"""

import dataclasses
import os
import shutil
import time

import pytest

pytest.importorskip("torch")

from video_stab_tpu.io import control as jcontrol  # noqa: E402
from video_stab_tpu.utils import config as jconfig  # noqa: E402
from video_stab_tpu_torch.io import control as tcontrol  # noqa: E402
from video_stab_tpu_torch.utils import config as tconfig  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs"))
                 if f.endswith(".yaml"))

QUIRKS = """%YAML:1.0
video_source: "rtsp://camera.local:8554/live"
output_url: "out.avi"
mode:
  use_cuda: 1
  stabilizer_enabled: "true"
  tracker_enabled: yes
stabilizer:
  smoothing_radius: 21.0
  smoothing_method: gausian
  border_type: reflect_101
  feature_detector_type: 2
  jitter_frequency: 1
  fadeAlpha: 0.9
  fadeDuration: 12
  roi_x: 192
  roi_y: 108
  roi_width: 1536
  roi_height: 864
  what_is_this: 3
roll_correction:
  angle_filter_max: 70
deepstream_tracker:
  processing_width: 960
  confidence_threshold: 0.1
roll_fusion: false
"""


def _same(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    for f in dataclasses.fields(jax_cfg):
        a, b = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(b):
            assert type(a).__name__ == type(b).__name__, f.name


@pytest.mark.parametrize("name", CONFIGS)
def test_shipped_config_equals_jax(name):
    path = os.path.join(REPO, "configs", name)
    _same(tconfig.load_config(path), jconfig.load_config(path))


def test_reference_quirks_parse_like_jax():
    cfg = tconfig.parse_config_text(QUIRKS)
    _same(cfg, jconfig.parse_config_text(QUIRKS))
    assert cfg.stabilizer.smoothing_method == "gaussian"
    assert cfg.stabilizer.feature_detector == "fast"
    assert cfg.stabilizer.jitter_frequency == "medium"
    assert cfg.stabilizer.roi == (192, 108, 1536, 864)
    assert cfg.output_source == "out.avi" and cfg.roll_fusion is False


@pytest.mark.parametrize("name", CONFIGS)
def test_save_matches_jax_and_round_trips(name, tmp_path):
    cfg = tconfig.load_config(os.path.join(REPO, "configs", name))
    ours, theirs = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    tconfig.save_config(cfg, ours)
    jconfig.save_config(jconfig.load_config(
        os.path.join(REPO, "configs", name)), theirs)
    assert open(ours).read() == open(theirs).read()
    assert tconfig.load_config(ours) == cfg


def test_header_is_filestorage_dialect(tmp_path):
    path = str(tmp_path / "c.yaml")
    tconfig.save_config(tconfig.AppConfig(), path)
    assert open(path).readline().strip() == "%YAML:1.0"
    assert os.listdir(tmp_path) == ["c.yaml"]     # replaced whole


def test_unknown_keys_ignored():
    cfg = tconfig.parse_config_text(
        "stabilizer:\n  smoothing_radius: 9\n  what_is_this: 3\n")
    assert cfg.stabilizer.smoothing_radius == 9


def test_rest_update_writes_what_jax_writes(tmp_path):
    src = os.path.join(REPO, "configs", "selftest.yaml")
    ours, theirs = str(tmp_path / "port.yaml"), str(tmp_path / "jax.yaml")
    shutil.copyfile(src, ours)
    shutil.copyfile(src, theirs)
    updates = {"smoothingRadius": 21, "gamma": 0.8, "horizonLock": True,
               "trackerEnabled": True, "videoSource": "synthetic:64x48",
               "nope": 1}
    res = tcontrol.apply_rest_update(ours, updates)
    assert res == jcontrol.apply_rest_update(theirs, updates)
    assert res["ignored"] == {"nope": 1}
    assert open(ours).read() == open(theirs).read()
    assert open(ours + ".backup").read() == open(src).read()
    cfg = tconfig.load_config(ours)
    assert cfg.stabilizer.smoothing_radius == 21
    assert cfg.mode.tracker_enabled is True


def test_watcher_fires_on_rewrite(tmp_path):
    path = str(tmp_path / "c.yaml")
    tconfig.save_config(tconfig.AppConfig(), path)
    seen = []
    w = tconfig.ConfigWatcher(path, seen.append)
    assert not w.check_once()
    cfg = dataclasses.replace(
        tconfig.AppConfig(), stabilizer=dataclasses.replace(
            tconfig.AppConfig().stabilizer, smoothing_radius=7))
    time.sleep(0.01)
    tconfig.save_config(cfg, path)
    os.utime(path, (time.time() + 5, time.time() + 5))
    assert w.check_once()
    assert seen[-1].stabilizer.smoothing_radius == 7
