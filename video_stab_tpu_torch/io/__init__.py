"""Host runtime of the port: frame sources and sinks, the named-channel
stream graph with hot-switchable routing, TCP + REST control, and the
application orchestrator (``video_stab_tpu/io`` in the JAX package,
without its native codec layer: ROADMAP queue 1 item 13b)."""

from video_stab_tpu_torch.io.sources import (
    FrameSource,
    OpenCVSource,
    SourceParams,
    SyntheticSource,
    open_source,
)
from video_stab_tpu_torch.io.sinks import (
    CallbackSink,
    EncoderParams,
    FileSink,
    FrameSink,
    MJPEGServer,
    NullSink,
    bitrate_bps_app,
    bitrate_kbps_server,
    open_sink,
)
from video_stab_tpu_torch.io.channels import (
    Channel,
    ChannelBridge,
    Pipeline,
    StreamGraph,
)
from video_stab_tpu_torch.io.control import (
    ConfigRestServer,
    KeyboardController,
    TcpReceiver,
    TcpReciever,
    apply_rest_update,
)
from video_stab_tpu_torch.io.runner import StabilizerApp, run_app

__all__ = [
    "FrameSource", "OpenCVSource", "SyntheticSource", "SourceParams",
    "open_source",
    "FrameSink", "FileSink", "NullSink", "CallbackSink", "MJPEGServer",
    "EncoderParams", "open_sink", "bitrate_kbps_server", "bitrate_bps_app",
    "Channel", "ChannelBridge", "Pipeline", "StreamGraph",
    "TcpReceiver", "TcpReciever", "ConfigRestServer", "KeyboardController",
    "apply_rest_update",
    "StabilizerApp", "run_app",
]
