"""Generation diagnostics of the port: MIDI statistics and the quality gate."""
