"""MIDI of the port: the GM program table (``gm``), the SMF byte codec
(``smf``), the note-level object model (``midifile``) and the piano-roll
renderer (``codec``), numpy-only copies of the JAX package's modules; and
the native encoder (``native``, a ctypes bridge to ``midi_codec.cpp``,
built with g++ at first use)."""
