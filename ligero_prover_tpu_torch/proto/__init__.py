"""Generated protobuf bindings for the proof wire format.

protoc emits absolute imports, so this package dir is appended to sys.path
before loading the generated modules.
"""
import os
import sys

_here = os.path.dirname(__file__)
if _here not in sys.path:
    sys.path.insert(0, _here)

from . import ligero_common_pb2  # noqa: E402,F401
from . import ligero_proof_pb2  # noqa: E402,F401
