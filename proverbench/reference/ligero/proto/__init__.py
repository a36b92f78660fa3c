"""Generated protobuf bindings of the proof wire format (a frozen copy)."""
