"""Host runtime of the port (``video_stab_tpu/io`` in the JAX package):
frame sources and sinks, the native codec layer (H.264 / H.265 encode and
decode, MP4 / MKV mux and demux), the RTSP server, the compressed-domain
packet graph, the named-channel stream graph with hot-switchable routing
(the gstd/interpipe analog) and its out-of-process daemon, remote frame
ingest, TCP + REST control, and the application orchestrator."""

from video_stab_tpu_torch.io.sources import (
    FrameSource,
    OpenCVSource,
    SourceParams,
    SyntheticSource,
    open_source,
)
from video_stab_tpu_torch.io.sinks import (
    CallbackSink,
    ContainerSink,
    EncoderParams,
    FileSink,
    FrameSink,
    H264FileSink,
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
from video_stab_tpu_torch.io.daemon import GraphDaemonClient
from video_stab_tpu_torch.io.packets import (
    ContainerPacketSource,
    PacketDecoderBridge,
    PacketEncoderBridge,
    PacketFileSink,
    PacketRelay,
    PacketSource,
    RtspPacketSource,
    open_packet_sink,
    open_packet_source,
)
from video_stab_tpu_torch.io.control import (
    ConfigRestServer,
    KeyboardController,
    TcpReceiver,
    TcpReciever,
    apply_rest_update,
)
from video_stab_tpu_torch.io.remote import RemoteFrameServer, RemoteFrameSink
from video_stab_tpu_torch.io.rtsp import RTSPServer
from video_stab_tpu_torch.io.runner import StabilizerApp, run_app

__all__ = [
    "FrameSource", "OpenCVSource", "SyntheticSource", "SourceParams",
    "open_source",
    "FrameSink", "FileSink", "NullSink", "CallbackSink", "MJPEGServer",
    "H264FileSink", "ContainerSink",
    "EncoderParams", "open_sink", "bitrate_kbps_server", "bitrate_bps_app",
    "Channel", "ChannelBridge", "Pipeline", "StreamGraph",
    "GraphDaemonClient",
    "ContainerPacketSource", "PacketDecoderBridge", "PacketEncoderBridge",
    "PacketFileSink", "PacketRelay", "PacketSource", "RtspPacketSource",
    "open_packet_sink", "open_packet_source",
    "TcpReceiver", "TcpReciever", "ConfigRestServer", "KeyboardController",
    "apply_rest_update",
    "RemoteFrameSink", "RemoteFrameServer", "RTSPServer",
    "StabilizerApp", "run_app",
]
