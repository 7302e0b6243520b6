"""Socket transport for the control plane: the port of ``repro/net``.

The multi-host seam behind ``core/servers.py``: the same versioned
parameter stores and exact-criterion data server, reachable over TCP, with
the reference's wire format (docs/WIRE_PROTOCOL.md), byte for byte.

* :mod:`repro_torch.net.frame`: the 32-byte frame header (the version word
  rides the header, so unchanged pulls move zero array bytes) and the
  LeafCodec / tree-frame payload encodings;
* :mod:`repro_torch.net.control`: :class:`ControlPlane`, the threaded
  server hosting every store of a run behind one ``--bind`` address;
* :mod:`repro_torch.net.client`: :class:`TcpParameterServer` /
  :class:`TcpDataServer`, drop-in peers of the procs engine's stores;
* :mod:`repro_torch.net.join`: ``--connect``, joining a live run as extra
  collectors.
"""
from repro_torch.net.client import TcpDataServer, TcpParameterServer
from repro_torch.net.control import ControlPlane, parse_addr
from repro_torch.net.frame import ProtocolError
from repro_torch.net.join import join_as_collectors

__all__ = ["ControlPlane", "TcpParameterServer", "TcpDataServer",
           "ProtocolError", "parse_addr", "join_as_collectors"]
