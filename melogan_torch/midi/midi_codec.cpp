// Native MIDI encoder of the port: the host-side end of the serving and
// sampling path. Produces Standard MIDI File bytes byte-identical to the
// port's Python writer (melogan_torch/midi/midifile.py, smf.py): format 1,
// division as given, a timing track (set_tempo + 4/4 time signature), one
// instrument track on channel 0 with running-status note_on events
// (velocity-0 note-offs), events ordered by (tick, pitch<<8 | velocity),
// end-of-track at last tick + 1.
//
// The port's own copy of native/midi_codec.cpp, with the same C ABI
// (melomidi_write). Where it differs, and why: the JAX copy encodes every
// input, and so writes bytes for songs the Python writer refuses. This copy
// refuses exactly those songs, in the Python writer's order, and writes no
// bytes for them:
//   - a tick below 0 (a note before time 0) returns MELOMIDI_NEGATIVE_TICK.
//     The JAX copy writes the negative delta as a 10-byte varlen, which
//     reads back as a time of about 2.7e18 s. The Python writer raises
//     "events must be sorted by tick".
//   - a program, pitch or velocity outside 0..255 returns
//     MELOMIDI_BYTE_RANGE. The JAX copy masks them with & 0x7F. The Python
//     writer raises "bytes must be in range(0, 256)", and writes 128..255 as
//     they are, so this copy writes those bytes unmasked too.
// The tempo's and the division's ranges are checked by the caller (the
// Python writer packs them with struct, which raises struct.error).
//
// Build:  g++ -O3 -shared -fPIC -std=c++17 -o libmelomidi.so midi_codec.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int64_t MELOMIDI_BAD_CALL = -1;
constexpr int64_t MELOMIDI_NEGATIVE_TICK = -2;
constexpr int64_t MELOMIDI_BYTE_RANGE = -3;

struct Event {
  int64_t tick;
  uint32_t subkey;  // (pitch<<8) | velocity: the note events' order in a tick
  uint8_t pitch;
  uint8_t velocity;  // 0 for note-off
};

inline bool is_byte(int32_t v) { return v >= 0 && v <= 255; }

inline void put_varlen(std::vector<uint8_t>& out, int64_t value) {
  uint8_t buf[10];
  int n = 0;
  buf[n++] = static_cast<uint8_t>(value & 0x7F);
  value >>= 7;
  while (value) {
    buf[n++] = static_cast<uint8_t>(0x80 | (value & 0x7F));
    value >>= 7;
  }
  for (int i = n - 1; i >= 0; --i) out.push_back(buf[i]);
}

inline void put_u32(uint8_t* out, uint32_t v) {
  out[0] = static_cast<uint8_t>(v >> 24);
  out[1] = static_cast<uint8_t>(v >> 16);
  out[2] = static_cast<uint8_t>(v >> 8);
  out[3] = static_cast<uint8_t>(v);
}

}  // namespace

extern "C" {

// Encode a single-instrument song. Returns the number of bytes written,
// -needed_capacity if `out_capacity` is too small, -1 on a bad call, -2 for
// a tick below 0 and -3 for a program, pitch or velocity outside 0..255 (no
// bytes written for any of these).
int64_t melomidi_write(const int32_t* pitch, const int32_t* velocity,
                       const int64_t* start_tick, const int64_t* end_tick,
                       int64_t n_notes, int32_t program, int32_t channel,
                       int32_t tempo_us, int32_t division, uint8_t* out,
                       int64_t out_capacity) {
  if (n_notes < 0 || !out) return MELOMIDI_BAD_CALL;

  // --- refuse what the Python writer refuses, in its order ------------------
  for (int64_t i = 0; i < n_notes; ++i)
    if (start_tick[i] < 0 || end_tick[i] < 0) return MELOMIDI_NEGATIVE_TICK;
  if (!is_byte(program)) return MELOMIDI_BYTE_RANGE;
  for (int64_t i = 0; i < n_notes; ++i)
    if (!is_byte(pitch[i]) || !is_byte(velocity[i])) return MELOMIDI_BYTE_RANGE;

  // --- build + sort note events -------------------------------------------
  std::vector<Event> events;
  events.reserve(2 * n_notes);
  for (int64_t i = 0; i < n_notes; ++i) {
    uint8_t p = static_cast<uint8_t>(pitch[i]);
    uint8_t v = static_cast<uint8_t>(velocity[i]);
    events.push_back({start_tick[i], (uint32_t(p) << 8) | v, p, v});
    events.push_back({end_tick[i], uint32_t(p) << 8, p, 0});
  }
  std::stable_sort(events.begin(), events.end(),
                   [](const Event& a, const Event& b) {
                     if (a.tick != b.tick) return a.tick < b.tick;
                     return a.subkey < b.subkey;
                   });

  // --- timing track --------------------------------------------------------
  const uint8_t t0[] = {
      0x00, 0xFF, 0x51, 0x03, static_cast<uint8_t>(tempo_us >> 16),
      static_cast<uint8_t>(tempo_us >> 8), static_cast<uint8_t>(tempo_us),
      0x00, 0xFF, 0x58, 0x04, 0x04, 0x02, 0x18, 0x08,
      0x01, 0xFF, 0x2F, 0x00};

  // --- instrument track ----------------------------------------------------
  std::vector<uint8_t> t1;
  t1.reserve(8 + events.size() * 4);
  const uint8_t ch = static_cast<uint8_t>(channel & 0x0F);
  t1.push_back(0x00);
  t1.push_back(static_cast<uint8_t>(0xC0 | ch));
  t1.push_back(static_cast<uint8_t>(program));

  int64_t last_tick = 0;
  bool running = false;  // the program change set another status
  for (const Event& e : events) {
    put_varlen(t1, e.tick - last_tick);
    last_tick = e.tick;
    if (!running) {
      t1.push_back(static_cast<uint8_t>(0x90 | ch));
      running = true;
    }
    t1.push_back(e.pitch);
    t1.push_back(e.velocity);
  }
  // end of track at last tick + 1
  t1.push_back(0x01); t1.push_back(0xFF); t1.push_back(0x2F); t1.push_back(0x00);

  // --- assemble file -------------------------------------------------------
  const int64_t total = 14 + 8 + static_cast<int64_t>(sizeof(t0)) + 8 +
                        static_cast<int64_t>(t1.size());
  if (total > out_capacity) return -total;

  const uint8_t mthd[] = {'M', 'T', 'h', 'd', 0, 0, 0, 6, 0, 1, 0, 2,
                          static_cast<uint8_t>(division >> 8),
                          static_cast<uint8_t>(division)};
  uint8_t* p = out;
  std::memcpy(p, mthd, sizeof(mthd)); p += sizeof(mthd);
  std::memcpy(p, "MTrk", 4); put_u32(p + 4, sizeof(t0)); p += 8;
  std::memcpy(p, t0, sizeof(t0)); p += sizeof(t0);
  std::memcpy(p, "MTrk", 4); put_u32(p + 4, static_cast<uint32_t>(t1.size())); p += 8;
  std::memcpy(p, t1.data(), t1.size());
  return total;
}

}  // extern "C"
