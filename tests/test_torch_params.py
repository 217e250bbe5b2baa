"""The PyTorch port's parameter copies against the JAX package's originals,
and the port's import boundary (it never imports JAX)."""

import dataclasses
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from video_stab_tpu.core import chain as jchain  # noqa: E402
from video_stab_tpu.core import params as jparams  # noqa: E402
from video_stab_tpu_torch.core import chain as tchain  # noqa: E402
from video_stab_tpu_torch.core import params as tparams  # noqa: E402

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
COPIED = ("StabilizerParams", "EnhancerParams", "RollCorrectionParams",
          "ModeParams", "AutoZoomCropParams", "LegacyStabilizerParams")


@pytest.mark.parametrize("name", COPIED)
def test_dataclass_copied_field_for_field(name):
    j, t = getattr(jparams, name), getattr(tparams, name)
    jf, tf = dataclasses.fields(j), dataclasses.fields(t)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.default for f in tf] == [f.default for f in jf]
    assert [f.type for f in tf] == [f.type for f in jf]
    assert t.__dataclass_params__.frozen
    jprops = sorted(k for k, v in vars(j).items() if isinstance(v, property))
    tprops = sorted(k for k, v in vars(t).items() if isinstance(v, property))
    assert tprops == jprops


@pytest.mark.parametrize("kw", [
    {}, {"smoothing_radius": 2}, {"smoothing_radius": 99},
    {"border_size": 12}, {"smoothing_radius": 15, "border_size": -3}])
def test_stabilizer_properties_agree(kw):
    j, t = jparams.StabilizerParams(**kw), tparams.StabilizerParams(**kw)
    assert t.effective_radius == j.effective_radius
    assert t.border_pad == j.border_pad


@pytest.mark.parametrize("radius", [1, 4, 5, 11, 30, 31, 99])
def test_legacy_properties_agree(radius):
    j = jparams.LegacyStabilizerParams(smoothing_radius=radius)
    t = tparams.LegacyStabilizerParams(smoothing_radius=radius)
    assert t.effective_radius == j.effective_radius
    assert t.box_radius == j.box_radius


@pytest.mark.parametrize("variant", [
    {}, {"fuse_roll": False}, {"roll": {"angle_filter_max": 70.0}},
    {"stabilizer": {"border_size": 8}}, {"azc": {"enabled": True}},
    {"stabilizer": {"motion_model": "homography"}},
    {"mode": {"stabilizer_enabled": False}}])
def test_chain_params_properties_agree(variant):
    def build(pm, cm):
        parts = {
            "mode": pm.ModeParams(**{"enhancer_enabled": True,
                                     "roll_correction_enabled": True,
                                     "stabilizer_enabled": True,
                                     **variant.get("mode", {})}),
            "enhancer": pm.EnhancerParams(brightness=5.0, contrast=1.1,
                                          gamma=0.9),
            "roll": pm.RollCorrectionParams(**variant.get("roll", {})),
            "stabilizer": pm.StabilizerParams(
                smoothing_radius=15, **variant.get("stabilizer", {})),
            "azc": pm.AutoZoomCropParams(**variant.get("azc", {})),
        }
        return cm.ChainParams(fuse_roll=variant.get("fuse_roll", True),
                              **parts)

    j = build(jparams, jchain)
    t = build(tparams, tchain)
    assert list(t._fields) == list(j._fields)
    for prop in ("roll_band_deg", "roll_fusion_active", "aux_envelope_deg"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert dataclasses.asdict(t.stabilizer_eff) == \
        dataclasses.asdict(j.stabilizer_eff)
    assert t.AUX_ENVELOPE_CAP_DEG == j.AUX_ENVELOPE_CAP_DEG


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {os.path.abspath(REPO)!r})\n"
        "import video_stab_tpu_torch\n"
        "import video_stab_tpu_torch.core.chain\n"
        "import video_stab_tpu_torch.core.stabilizer\n"
        "import video_stab_tpu_torch.kernels.warp\n"
        "import video_stab_tpu_torch.kernels.features\n"
        "import video_stab_tpu_torch.kernels.enhance\n"
        "import video_stab_tpu_torch.kernels.traj\n"
        "import video_stab_tpu_torch.motion.homography\n"
        "import video_stab_tpu_torch.motion.hf\n"
        "import video_stab_tpu_torch.motion.l1path\n"
        "import video_stab_tpu_torch.motion.filters\n"
        "import video_stab_tpu_torch.ops.filters\n"
        "import video_stab_tpu_torch.offline\n"
        "import video_stab_tpu_torch.core.canvas\n"
        "import video_stab_tpu_torch.core.legacy\n"
        "import video_stab_tpu_torch.ops.fast\n"
        "import video_stab_tpu_torch.models.deepstab\n"
        "import video_stab_tpu_torch.models.flax_msgpack\n"
        "import video_stab_tpu_torch.parallel\n"
        "import video_stab_tpu_torch.parallel.multistream\n"
        "import video_stab_tpu_torch.models.detector\n"
        "import video_stab_tpu_torch.models.tracker\n"
        "import video_stab_tpu_torch.utils\n"
        "import video_stab_tpu_torch.utils.telemetry\n"
        "import video_stab_tpu_torch.utils.config\n"
        "import video_stab_tpu_torch.utils.checkpoint\n"
        "import video_stab_tpu_torch.io\n"
        "import video_stab_tpu_torch.io.sources\n"
        "import video_stab_tpu_torch.io.sinks\n"
        "import video_stab_tpu_torch.io.channels\n"
        "import video_stab_tpu_torch.io.control\n"
        "import video_stab_tpu_torch.io.runner\n"
        "import video_stab_tpu_torch.io.codec\n"
        "import video_stab_tpu_torch.io.rtsp\n"
        "import video_stab_tpu_torch.io.packets\n"
        "import video_stab_tpu_torch.io.remote\n"
        "import video_stab_tpu_torch.io.daemon\n"
        "import video_stab_tpu_torch.native\n"
        "import video_stab_tpu_torch.cli\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith(('jax.', 'jaxlib',\n"
        "                                            'video_stab_tpu.'))\n"
        "             or m in ('video_stab_tpu', 'cv2', 'flax', 'msgpack')\n"
        "             or m.startswith(('flax.', 'msgpack.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    # -I: no PYTHONPATH or user site, so nothing but the port can pull
    # JAX in at interpreter start.
    proc = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_daemon_child_code_never_names_the_jax_package():
    """The graph daemon's child process runs the port's stream graph: its
    code names no module of the JAX package."""
    import re

    from video_stab_tpu_torch.io import daemon

    assert not re.search(r"\bvideo_stab_tpu\.", daemon._SERVER_CODE)
    assert "import jax" not in daemon._SERVER_CODE
    assert "video_stab_tpu_torch.io." in daemon._SERVER_CODE


def test_use_cuda_without_a_device_raises(monkeypatch):
    from video_stab_tpu_torch import pick_device
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.stabilizer import Stabilizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="use_cuda"):
        pick_device(True)
    with pytest.raises(RuntimeError, match="use_cuda"):
        Stabilizer(tparams.StabilizerParams())
    with pytest.raises(RuntimeError, match="use_cuda"):
        ProcessingChain(tparams.ModeParams(), tparams.EnhancerParams(),
                        tparams.RollCorrectionParams(),
                        tparams.StabilizerParams())
    assert pick_device(False) == torch.device("cpu")


@pytest.mark.parametrize("kw", [
    {"motion_model": "homography", "smoothing_method": "kalman"},
    {"smoothing_method": "kalman"},
    {"drone_high_freq_mode": True}, {"border_size": 10},
    {"enable_virtual_canvas": True}, {"feature_detector": "fast"},
    {"deep_stabilization": True},
    {"motion_model": "homography", "border_size": 10},
    {"motion_model": "homography", "drone_high_freq_mode": True}])
def test_unported_stabilizer_branches_raise(kw):
    """No branch is left unported: both motion models with every streaming
    smoother, the drone high-frequency mode, borders, the virtual canvas,
    every detector and deep stabilization all construct."""
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    params = tparams.StabilizerParams(**kw)
    mode = tparams.ModeParams(use_cuda=False)
    assert Stabilizer(params, mode=mode).params is params


@pytest.mark.parametrize("kw", [
    {"smoothing_method": "l1"}, {"smoothing_method": "median"},
    {"feature_detector": "sift"}, {"motion_model": "affine"}])
def test_unknown_or_unported_stabilizer_options_raise(kw):
    """l1 is an offline smoother; the other values are unknown."""
    from video_stab_tpu_torch.core.stabilizer import Stabilizer
    with pytest.raises(NotImplementedError):
        Stabilizer(tparams.StabilizerParams(**kw),
                   mode=tparams.ModeParams(use_cuda=False))


@pytest.mark.parametrize("what", ["azc", "i420", "two_pass", "pipelined",
                                  "clahe"])
def test_unported_chain_variants_raise(what):
    """The chain variants and the enhancer stages that once raised are
    ported: each constructs (the CLAHE enhancer runs), and so does each
    with the BRISK detector; only an unknown stabilizer value raises
    through the chain."""
    from video_stab_tpu_torch.core.chain import ProcessingChain
    from video_stab_tpu_torch.core.enhancer import enhance_frame
    mode = tparams.ModeParams(use_cuda=False, enhancer_enabled=True,
                              roll_correction_enabled=True,
                              stabilizer_enabled=True)
    kw = {}
    enh = tparams.EnhancerParams()
    if what == "azc":
        kw["azc"] = tparams.AutoZoomCropParams(enabled=True)
    elif what == "i420":
        kw["output_format"] = "i420"
    elif what == "two_pass":
        kw["fuse_roll"] = False
    elif what == "pipelined":
        kw["pipelined"] = True
    else:
        enh = tparams.EnhancerParams(enable_clahe=True)
        out = enhance_frame(enh, torch.full((16, 16, 3), 90.0))
        assert out.shape == (16, 16, 3)
    ch = ProcessingChain(mode, enh, tparams.RollCorrectionParams(),
                         tparams.StabilizerParams(), **kw)
    assert ch.pipelined == (what == "pipelined")
    assert ch.params.roll_fusion_active == (what in ("i420", "pipelined",
                                                     "clahe"))
    ProcessingChain(mode, enh, tparams.RollCorrectionParams(),
                    tparams.StabilizerParams(feature_detector="brisk"), **kw)
    with pytest.raises(NotImplementedError, match="unknown"):
        ProcessingChain(mode, enh, tparams.RollCorrectionParams(),
                        tparams.StabilizerParams(feature_detector="sift"),
                        **kw)


@pytest.mark.parametrize("kw", [
    {"deep_stabilization": True}, {"enable_virtual_canvas": True},
    {"enable_virtual_canvas": True, "adaptive_canvas_size": False},
    {"feature_detector": "fast"}, {"feature_detector": "orb"},
    {"feature_detector": "brisk"},
    {"deep_stabilization": True, "enable_virtual_canvas": True,
     "feature_detector": "orb", "drone_high_freq_mode": True}])
def test_check_supported_raises_for_none_of_the_ported_branches(kw):
    """The branches of ROADMAP queue 1 item 9 pass both ``check_supported``
    functions (the stabilizer's and the chain's)."""
    from video_stab_tpu_torch.core.stabilizer import check_supported
    params = tparams.StabilizerParams(**kw)
    check_supported(params)
    mode = tparams.ModeParams(use_cuda=False, stabilizer_enabled=True)
    tchain.check_supported(tchain.ChainParams(
        mode=mode, enhancer=tparams.EnhancerParams(),
        roll=tparams.RollCorrectionParams(), stabilizer=params,
        azc=tparams.AutoZoomCropParams()))
