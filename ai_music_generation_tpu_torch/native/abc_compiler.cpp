// ABC notation -> note-event compiler (native implementation).
//
// The reference pipeline shells out to the C `abc2midi` binary
// (ref: scripts/common/abc_to_midi_wav_and_aesthetics.py:118). This is the
// framework's native equivalent: it implements the same ABC grammar subset
// as the Python semantic reference (ai_music_generation_tpu/abcnotation/
// parser.py) — the two are differentially tested against each other — and
// exposes a C ABI consumed via ctypes (abcnotation/native.py).
//
// Time is exact rational quarter-lengths (Frac), so triplet grids survive
// the trip to MIDI ticks without rounding.
//
// Build: make -C native   (produces libabc_compiler.so)

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <map>
#include <numeric>
#include <string>
#include <string_view>
#include <vector>

namespace {

struct Frac {
  int64_t num = 0;
  int64_t den = 1;
  Frac() = default;
  Frac(int64_t n, int64_t d = 1) : num(n), den(d) { norm(); }
  void norm() {
    if (den < 0) { num = -num; den = -den; }
    int64_t g = std::gcd(num < 0 ? -num : num, den);
    if (g > 1) { num /= g; den /= g; }
    if (num == 0) den = 1;
  }
  Frac operator+(const Frac& o) const { return Frac(num * o.den + o.num * den, den * o.den); }
  Frac operator-(const Frac& o) const { return Frac(num * o.den - o.num * den, den * o.den); }
  Frac operator*(const Frac& o) const { return Frac(num * o.num, den * o.den); }
  bool operator<(const Frac& o) const { return num * o.den < o.num * den; }
  bool operator==(const Frac& o) const { return num == o.num && den == o.den; }
  double value() const { return double(num) / double(den); }
};

struct Event {
  int32_t pitch;  // -1 = rest
  Frac start;
  Frac dur;
  int32_t voice;
};

const char* kSharpOrder = "FCGDAEB";

int letterSemitone(char c) {
  switch (c) {
    case 'C': return 0; case 'D': return 2; case 'E': return 4;
    case 'F': return 5; case 'G': return 7; case 'A': return 9;
    case 'B': return 11;
  }
  return 0;
}

bool majorSharps(const std::string& tonic, int* out) {
  static const std::map<std::string, int> table = {
      {"C", 0}, {"G", 1}, {"D", 2}, {"A", 3}, {"E", 4}, {"B", 5},
      {"F#", 6}, {"C#", 7}, {"F", -1}, {"Bb", -2}, {"Eb", -3}, {"Ab", -4},
      {"Db", -5}, {"Gb", -6}, {"Cb", -7}};
  auto it = table.find(tonic);
  if (it == table.end()) return false;
  *out = it->second;
  return true;
}

int modeOffset(const std::string& mode) {
  // longest-prefix match, mirroring parser.py _MODE_OFFSET
  static const std::vector<std::pair<std::string, int>> modes = {
      {"mixolydian", -1}, {"locrian", -5}, {"phrygian", -4}, {"aeolian", -3},
      {"dorian", -2}, {"ionian", 0}, {"lydian", 1}, {"major", 0},
      {"minor", -3}, {"maj", 0}, {"min", -3}, {"mix", -1}, {"dor", -2},
      {"phr", -4}, {"lyd", 1}, {"loc", -5}, {"aeo", -3}, {"ion", 0},
      {"m", -3}};
  for (const auto& [name, off] : modes) {
    if (mode.rfind(name, 0) == 0) return off;
  }
  return 0;
}

int keySignatureSharps(const std::string& key) {
  size_t i = 0;
  while (i < key.size() && isspace((unsigned char)key[i])) i++;
  if (i >= key.size()) return 0;
  std::string rest = key.substr(i);
  std::string lower;
  for (char c : rest) lower.push_back(tolower((unsigned char)c));
  if (lower == "none") return 0;
  char letter = toupper((unsigned char)rest[0]);
  if (letter < 'A' || letter > 'G') return 0;  // parser.py: tonic [A-Ga-g]
  std::string tonic(1, letter);
  size_t j = 1;
  if (j < rest.size() && (rest[j] == '#' || rest[j] == 'b')) {
    tonic.push_back(rest[j]);
    j++;
  }
  while (j < rest.size() && isspace((unsigned char)rest[j])) j++;
  std::string mode;
  while (j < rest.size() && isalpha((unsigned char)rest[j]))
    mode.push_back(tolower((unsigned char)rest[j++]));
  int base = 0;
  if (!majorSharps(tonic, &base)) return 0;  // unknown tonic (e.g. B#):
  return base + modeOffset(mode);            // 0 sharps, NO mode offset
}

struct VoiceState {
  Frac time;
  std::map<std::pair<char, int>, int> measureAcc;
  char pendingBroken = 0;
  int brokenCount = 0;
  int tupletRemaining = 0;
  Frac tupletFactor{1, 1};
  int tiePendingIdx = -1;  // index into events
  std::vector<int> lastGroup;  // THIS voice's last note(s) sharing a start
                               // (broken rhythm / ties resolve per voice)
  int repeatStartIdx = 0;
  Frac repeatStartTime;
  int firstEndingStart = -1;
  Frac firstEndingTime;
  std::vector<int> pendingGraces;  // pitches awaiting a principal note
};

// gchord chord-type table (mirrors parser.py _CHORD_TYPES; unknown types
// fall back to a major triad like abc2midi).
const std::vector<std::pair<std::string, std::vector<int>>>& chordTypes() {
  static const std::vector<std::pair<std::string, std::vector<int>>> table = {
      {"", {0, 4, 7}}, {"maj", {0, 4, 7}}, {"M", {0, 4, 7}},
      {"6", {0, 4, 7, 9}}, {"m6", {0, 3, 7, 9}},
      {"7", {0, 4, 7, 10}}, {"maj7", {0, 4, 7, 11}}, {"M7", {0, 4, 7, 11}},
      {"9", {0, 4, 7, 10, 14}}, {"maj9", {0, 4, 7, 11, 14}},
      {"M9", {0, 4, 7, 11, 14}}, {"11", {0, 4, 7, 10, 14, 17}},
      {"m", {0, 3, 7}}, {"min", {0, 3, 7}}, {"-", {0, 3, 7}},
      {"m7", {0, 3, 7, 10}}, {"min7", {0, 3, 7, 10}}, {"-7", {0, 3, 7, 10}},
      {"m9", {0, 3, 7, 10, 14}},
      {"dim", {0, 3, 6}}, {"dim7", {0, 3, 6, 9}}, {"m7b5", {0, 3, 6, 10}},
      {"aug", {0, 4, 8}}, {"+", {0, 4, 8}},
      {"aug7", {0, 4, 8, 10}}, {"+7", {0, 4, 8, 10}},
      {"sus", {0, 5, 7}}, {"sus4", {0, 5, 7}}, {"sus2", {0, 2, 7}},
      {"7sus4", {0, 5, 7, 10}}, {"7sus2", {0, 2, 7, 10}},
  };
  return table;
}

constexpr int kGraceNum = 1, kGraceDen = 4;  // graces steal 1/4 of the span
constexpr int kFundamentalBase = 36;         // gchord 'f' octave (C2)
constexpr int kChordBase = 48;               // gchord 'c' octave (C3)

struct ParsedChord {
  int rootPc;
  std::vector<int> intervals;
  int bassPc;  // -1 = none
};

// "G7" / "Dm/F#" -> chord, or false for non-chord annotations.
bool parseChordSymbol(const std::string& raw, ParsedChord* out) {
  size_t a = raw.find_first_not_of(" \t");
  if (a == std::string::npos) return false;
  size_t b = raw.find_last_not_of(" \t");
  std::string s = raw.substr(a, b - a + 1);
  size_t i = 0;
  if (s.empty() || s[0] < 'A' || s[0] > 'G') return false;
  int rootPc = letterSemitone(s[i++]);
  if (i < s.size() && (s[i] == '#' || s[i] == 'b')) {
    rootPc += (s[i] == '#') ? 1 : -1;
    i++;
  }
  rootPc = ((rootPc % 12) + 12) % 12;
  std::string type;
  int bassPc = -1;
  for (; i < s.size(); ++i) {
    char c = s[i];
    if (c == '/') {
      i++;
      if (i >= s.size() || s[i] < 'A' || s[i] > 'G') return false;
      bassPc = letterSemitone(s[i++]);
      if (i < s.size() && (s[i] == '#' || s[i] == 'b')) {
        bassPc += (s[i] == '#') ? 1 : -1;
        i++;
      }
      bassPc = ((bassPc % 12) + 12) % 12;
      if (i != s.size()) return false;
      break;
    }
    if (!(isalnum((unsigned char)c) || c == '+' || c == '-')) return false;
    type.push_back(c);
  }
  out->rootPc = rootPc;
  out->bassPc = bassPc;
  out->intervals = chordTypes()[0].second;  // default: major
  for (const auto& [name, ivs] : chordTypes()) {
    if (name == type) { out->intervals = ivs; break; }
  }
  return true;
}

// abc2midi's meter-derived default patterns; one char per eighth note.
std::string gchordPattern(int num, int den) {
  int64_t n8 = 8LL * num;
  if (n8 % den != 0) return "";
  int slots = (int)(n8 / den);
  std::string out;
  if (den == 8 && num % 3 == 0) {
    for (int k = 0; k < num / 3; ++k) out += "fzc";
    return out;
  }
  if (num == 3 && den == 4) return "fzczcz";
  if (slots % 4 == 0) {
    for (int k = 0; k < slots / 4; ++k) out += "fzcz";
    return out;
  }
  if (slots % 2 == 0) {
    for (int k = 0; k < slots / 2; ++k) out += "fz";
    return out;
  }
  return "";
}

struct Parser {
  std::string text;
  size_t i = 0;
  int meterNum = 4, meterDen = 4;
  Frac unitLen{1, 8};
  bool explicitL = false;
  double tempoBpm = 120.0;
  int sharps = 0;
  std::vector<Event> events;
  std::map<std::string, VoiceState> voices;
  std::vector<std::string> voiceIds;
  std::string curVoice = "1";
  std::vector<std::pair<Frac, std::string>> chordSymbols;
  int accompVoice = -1;

  VoiceState& voice(const std::string& id) {
    if (!voices.count(id)) {
      voices[id] = VoiceState();
      voiceIds.push_back(id);
    }
    return voices[id];
  }
  int voiceIndex(const std::string& id) {
    for (size_t k = 0; k < voiceIds.size(); ++k)
      if (voiceIds[k] == id) return (int)k;
    return 0;
  }

  std::map<char, int> keyAcc;
  void rebuildKeyAcc() {
    keyAcc.clear();
    if (sharps > 0)
      for (int k = 0; k < sharps && k < 7; ++k) keyAcc[kSharpOrder[k]] = 1;
    else if (sharps < 0)
      for (int k = 0; k < -sharps && k < 7; ++k) keyAcc[kSharpOrder[6 - k]] = -1;
  }

  // ---- header -------------------------------------------------------------
  bool parseMeter(const std::string& v) {
    // parser.py _parse_meter falls back to (4,4) on ANY non-matching value
    if (!parseMeterInner(v)) { meterNum = 4; meterDen = 4; return false; }
    return true;
  }

  bool parseMeterInner(const std::string& v) {
    std::string s = v;
    while (!s.empty() && isspace((unsigned char)s.back())) s.pop_back();
    size_t b = 0;
    while (b < s.size() && isspace((unsigned char)s[b])) b++;
    s = s.substr(b);
    if (s == "C") { meterNum = 4; meterDen = 4; return true; }
    if (s == "C|") { meterNum = 2; meterDen = 2; return true; }
    int total = 0, cur = -1;
    size_t k = 0;
    for (; k < s.size(); ++k) {
      if (isdigit((unsigned char)s[k])) {
        if (cur < 0) cur = 0;
        cur = cur * 10 + (s[k] - '0');
      } else if (s[k] == '+') {
        if (cur >= 0) { total += cur; cur = -1; }
      } else if (s[k] == '/') {
        break;
      } else {
        return false;
      }
    }
    if (cur >= 0) total += cur;
    if (k >= s.size() || s[k] != '/' || total <= 0) return false;
    int den = atoi(s.c_str() + k + 1);
    if (den <= 0) return false;
    meterNum = total;
    meterDen = den;
    return true;
  }

  void parseTempo(const std::string& v) {
    // exact mirror of parser.py _parse_tempo + the falsy-bpm guard at its
    // call sites: prefix (\d+)/(\d+)\s*=\s*(\d+), else FULL-match bare
    // int; a zero/garbage value leaves the tempo unchanged (the old sscanf
    // version set tempo 0 for 'Q:0' -> ZeroDivision downstream, and 90 for
    // 'Q:90 apprx' which Python ignores — review finding)
    size_t n = v.size(), p = 0;
    while (p < n && isspace((unsigned char)v[p])) p++;
    auto digits = [&](size_t& q) -> long {
      if (q >= n || !isdigit((unsigned char)v[q])) return -1;
      long x = 0;
      while (q < n && isdigit((unsigned char)v[q]))
        x = x * 10 + (v[q++] - '0');
      return x;
    };
    size_t k = p;
    long a = digits(k);
    if (a >= 0 && k < n && v[k] == '/') {
      k++;
      long b = digits(k);
      if (b > 0) {
        while (k < n && isspace((unsigned char)v[k])) k++;
        if (k < n && v[k] == '=') {
          k++;
          while (k < n && isspace((unsigned char)v[k])) k++;
          long bpm = digits(k);
          if (bpm >= 0) {
            double t = bpm * (double(a) / b) * 4.0;
            if (t > 0) tempoBpm = t;
            return;  // prefix matched: never falls through (re.match)
          }
        }
      }
    }
    size_t e = n;
    while (e > p && isspace((unsigned char)v[e - 1])) e--;
    k = p;
    long x = digits(k);
    if (x > 0 && k == e) tempoBpm = x;
  }

  void parseHeaders(const std::string& input, std::string* body) {
    size_t pos = 0;
    bool inBody = false;
    std::string bodyAccum;
    while (pos <= input.size()) {
      size_t nl = input.find('\n', pos);
      std::string line = input.substr(pos, nl == std::string::npos ? std::string::npos : nl - pos);
      pos = (nl == std::string::npos) ? input.size() + 1 : nl + 1;
      // strip comments
      if (line.rfind("%%", 0) == 0) continue;
      size_t cpos = line.find('%');
      if (cpos != std::string::npos) line = line.substr(0, cpos);
      while (!line.empty() && isspace((unsigned char)line.back())) line.pop_back();
      if (line.empty()) continue;
      bool field_line =
          line.size() > 1 && isalpha((unsigned char)line[0]) && line[1] == ':';
      bool header = field_line && isupper((unsigned char)line[0]);
      if (!inBody && field_line && !header) {
        continue;  // lowercase field (w:, s:, ...) before K:: parser.py
      }            // drops it and stays in the header
      if (!inBody && header) {
        char tag = line[0];
        std::string val = line.substr(2);
        size_t vs = 0;
        while (vs < val.size() && isspace((unsigned char)val[vs])) vs++;
        val = val.substr(vs);
        if (tag == 'M') parseMeter(val);
        else if (tag == 'L') {
          int a, b;
          if (sscanf(val.c_str(), "%d/%d", &a, &b) == 2 && b > 0) {
            unitLen = Frac(a, b);
            explicitL = true;
          }
        } else if (tag == 'Q') parseTempo(val);
        else if (tag == 'K') {
          sharps = keySignatureSharps(val);
          inBody = true;
        }
        continue;
      }
      if (inBody) {
        // mid-body field LINES (parser.py parity): K:/M:/L:/Q: become
        // inline fields applied in sequence; V: passes through to the
        // body's voice switch; any other letter field (T:, S:, B:, E:,
        // w:, ...) is metadata and is skipped, never scanned as music
        if (line.size() > 1 && isalpha((unsigned char)line[0]) && line[1] == ':') {
          char tag = line[0];
          if (tag == 'M' || tag == 'L' || tag == 'K' || tag == 'Q') {
            std::string val = line.substr(2);
            size_t vs = 0;
            while (vs < val.size() && isspace((unsigned char)val[vs])) vs++;
            bodyAccum += '[';
            bodyAccum += tag;
            bodyAccum += ':';
            bodyAccum += val.substr(vs);
            bodyAccum += "]\n";
          } else if (tag == 'V' || tag == 'v') {
            bodyAccum += line;
            bodyAccum += '\n';
          }
          continue;
        }
        bodyAccum += line;
        bodyAccum += '\n';
      } else if (!field_line) {
        inBody = true;
        bodyAccum += line;
        bodyAccum += '\n';
      }
    }
    if (!explicitL) {
      // default L from meter: < 3/4 -> 1/16
      if (Frac(meterNum, meterDen) < Frac(3, 4)) unitLen = Frac(1, 16);
    }
    *body = bodyAccum;
  }

  // ---- body helpers -------------------------------------------------------
  static Frac parseLenAt(const std::string& s, size_t& k) {
    // EXACT mirror of parser.py's length tokenization (the _NOTE_RE len
    // group alternation  \d+/\d+ | /\d+ | \d+ | /+  ): a trailing '/'
    // after digits is NOT consumed ('A3/' is length 3 + stray slash), and
    // digits after a multi-slash run are NOT consumed ('A//2' is 1/4 then
    // a stray '2'). The old scanner accepted both, silently desyncing from
    // the Python compiler (review findings).
    auto digits = [&](size_t& q) -> int64_t {
      if (q >= s.size() || !isdigit((unsigned char)s[q])) return -1;
      int64_t x = 0;
      while (q < s.size() && isdigit((unsigned char)s[q]))
        x = x * 10 + (s[q++] - '0');
      return x;
    };
    if (k < s.size() && isdigit((unsigned char)s[k])) {
      int64_t num = digits(k);
      if (k + 1 < s.size() && s[k] == '/' &&
          isdigit((unsigned char)s[k + 1])) {
        size_t q = k + 1;
        int64_t den = digits(q);
        k = q;
        return Frac(num, den);
      }
      return Frac(num, 1);
    }
    if (k < s.size() && s[k] == '/') {
      if (k + 1 < s.size() && isdigit((unsigned char)s[k + 1])) {
        size_t q = k + 1;
        int64_t den = digits(q);
        k = q;
        return Frac(1, den);
      }
      int slashes = 0;
      while (k < s.size() && s[k] == '/') { slashes++; k++; }
      // cap: 1<<63 is signed-overflow UB; both compilers clamp the run at
      // 30 (documented deviation from exact 2^-n — sub-sample at any rate)
      return Frac(1, 1LL << std::min(slashes, 30));
    }
    return Frac(1, 1);
  }

  Frac parseLen() { return parseLenAt(text, i); }

  // _NOTE_RE acc-group parity: at s[k], match (up to TWO ^ or _, or one =)
  // followed by a note letter. Returns true and advances k past the
  // accidental (acc filled; letter NOT consumed) or leaves k untouched.
  // The old scanners consumed unlimited runs ('^^^A' became A-natural and
  // poisoned measureAcc; regex backtracking makes it ^ + A-double-sharp).
  static bool matchNoteAcc(const std::string& s, size_t k, size_t* k_out,
                           std::string* acc) {
    auto isNote = [&](size_t q) {
      return q < s.size() && strchr("ABCDEFGabcdefg", s[q]);
    };
    char c = (k < s.size()) ? s[k] : '\0';
    if (c == '^' || c == '_') {
      if (k + 1 < s.size() && s[k + 1] == c && isNote(k + 2)) {
        *acc = std::string(2, c);
        *k_out = k + 2;
        return true;
      }
      if (isNote(k + 1)) {
        *acc = std::string(1, c);
        *k_out = k + 1;
        return true;
      }
      return false;
    }
    if (c == '=') {
      if (isNote(k + 1)) {
        *acc = "=";
        *k_out = k + 1;
        return true;
      }
      return false;
    }
    if (isNote(k)) {
      acc->clear();
      *k_out = k;
      return true;
    }
    return false;
  }

  void emit(int pitch, Frac dur, VoiceState& st, int vidx) {
    if (st.tupletRemaining > 0) {
      dur = dur * st.tupletFactor;
      st.tupletRemaining--;
    }
    if (st.pendingBroken) {
      int k = st.brokenCount;
      Frac factorLong((1LL << (k + 1)) - 1, 1LL << k);
      Frac factorShort(1, 1LL << k);
      Frac prevF = (st.pendingBroken == '>') ? factorLong : factorShort;
      Frac thisF = (st.pendingBroken == '>') ? factorShort : factorLong;
      if (!st.lastGroup.empty()) {
        Frac maxPrev;
        for (int ei : st.lastGroup)
          if (maxPrev < events[ei].dur) maxPrev = events[ei].dur;
        Frac delta = maxPrev * (prevF - Frac(1));
        for (int ei : st.lastGroup) events[ei].dur = events[ei].dur * prevF;
        st.time = st.time + delta;
      }
      dur = dur * thisF;
      st.pendingBroken = 0;
      st.brokenCount = 0;
    }
    if (pitch >= 0 && st.tiePendingIdx >= 0 &&
        events[st.tiePendingIdx].pitch == pitch) {
      events[st.tiePendingIdx].dur = events[st.tiePendingIdx].dur + dur;
      st.pendingGraces.clear();  // graces can't split a tied note
      st.tiePendingIdx = -1;
      st.time = st.time + dur;
      return;
    }
    if (pitch < 0) {
      st.pendingGraces.clear();  // graces never attach to a rest
    } else if (!st.pendingGraces.empty()) {
      // graces steal the first kGraceNum/kGraceDen of the span, split
      // equally; the principal scales to the remainder (parser.py emit)
      Frac steal = dur * Frac(kGraceNum, kGraceDen);
      Frac per = steal * Frac(1, (int64_t)st.pendingGraces.size());
      for (int gp : st.pendingGraces) {
        events.push_back({(int32_t)gp, st.time, per, (int32_t)vidx});
        st.time = st.time + per;
      }
      st.pendingGraces.clear();
      dur = dur - steal;
    }
    events.push_back({(int32_t)pitch, st.time, dur, (int32_t)vidx});
    st.lastGroup.assign(1, (int)events.size() - 1);
    // a tie binds only the immediately-following note
    st.tiePendingIdx = -1;
    st.time = st.time + dur;
  }

  int notePitch(char letter, const std::string& acc, int octMarks, VoiceState& st) {
    char upper = toupper((unsigned char)letter);
    int octave = islower((unsigned char)letter) ? 5 : 4;
    octave += octMarks;
    auto key = std::make_pair(upper, octave);
    int alter;
    if (!acc.empty()) {
      if (acc == "^") alter = 1;
      else if (acc == "^^") alter = 2;
      else if (acc == "_") alter = -1;
      else if (acc == "__") alter = -2;
      else alter = 0;  // '='
      st.measureAcc[key] = alter;
    }
    if (st.measureAcc.count(key)) alter = st.measureAcc[key];
    else alter = keyAcc.count(upper) ? keyAcc[upper] : 0;
    return 12 * (octave + 1) + letterSemitone(upper) + alter;
  }

  void expandRepeat(VoiceState& st, int vidx) {
    int endIdx;
    Frac base = st.time;
    std::vector<Event> section;
    bool hasEnding = st.firstEndingStart >= 0;
    if (hasEnding) {
      endIdx = st.firstEndingStart;
    } else {
      endIdx = (int)events.size();
    }
    for (int k = st.repeatStartIdx; k < endIdx; ++k)
      if (events[k].voice == vidx) section.push_back(events[k]);
    Frac shift = st.time - st.repeatStartTime;
    for (const Event& e : section)
      events.push_back({e.pitch, e.start + shift, e.dur, e.voice});
    if (vidx == 0) {
      // chord symbols inside the repeated window play again too
      Frac windowEnd = hasEnding ? st.firstEndingTime : st.time;
      size_t nSyms = chordSymbols.size();
      for (size_t k = 0; k < nSyms; ++k) {
        const Frac& t = chordSymbols[k].first;
        if (!(t < st.repeatStartTime) && t < windowEnd)
          chordSymbols.emplace_back(t + shift, chordSymbols[k].second);
      }
    }
    // advance by the COPIED section's span: a [1 first ending is excluded
    // from the copy, so it is excluded from the advance too
    Frac sectionSpan = hasEnding ? (st.firstEndingTime - st.repeatStartTime)
                                 : shift;
    st.time = base + sectionSpan;
    st.repeatStartIdx = (int)events.size();
    st.repeatStartTime = st.time;
    st.firstEndingStart = -1;
  }

  bool match(const char* s) {
    size_t n = strlen(s);
    if (text.compare(i, n, s) == 0) { i += n; return true; }
    return false;
  }

  void parseBody(const std::string& body) {
    text = body;
    i = 0;
    rebuildKeyAcc();
    VoiceState* st = &voice(curVoice);
    Frac unitQl = unitLen * Frac(4);

    while (i < text.size()) {
      char ch = text[i];
      int vidx = voiceIndex(curVoice);
      if (ch == ' ' || ch == '\t' || ch == '\n' || ch == '\\') { i++; continue; }
      if (ch == '"') {  // chord symbol: record (time, text)
        size_t j = text.find('"', i + 1);
        std::string sym = (j == std::string::npos)
                              ? text.substr(i + 1)
                              : text.substr(i + 1, j - i - 1);
        if (!sym.empty() && !strchr("^_<>@", sym[0]))
          chordSymbols.emplace_back(st->time, sym);
        i = (j == std::string::npos) ? text.size() : j + 1;
        continue;
      }
      if (ch == '{') {  // grace group: collect pitches (lengths ignored)
        size_t j = text.find('}', i + 1);
        std::string inner = (j == std::string::npos)
                                ? text.substr(i + 1)
                                : text.substr(i + 1, j - i - 1);
        size_t k = 0;
        while (k < inner.size()) {
          std::string acc;
          size_t after_acc = k;
          if (matchNoteAcc(inner, k, &after_acc, &acc)) {
            k = after_acc;
            char letter = inner[k++];
            int octMarks = 0;
            while (k < inner.size() && (inner[k] == ',' || inner[k] == '\'')) {
              octMarks += (inner[k] == '\'') ? 1 : -1;
              k++;
            }
            st->pendingGraces.push_back(notePitch(letter, acc, octMarks, *st));
          } else {
            k++;
          }
        }
        i = (j == std::string::npos) ? text.size() : j + 1;
        continue;
      }
      if (ch == '!') {
        size_t j = text.find('!', i + 1);
        i = (j == std::string::npos) ? i + 1 : j + 1;
        continue;
      }
      if (ch == '+') {  // old-style +...+ decoration
        size_t j = text.find('+', i + 1);
        i = (j == std::string::npos) ? i + 1 : j + 1;
        continue;
      }
      if (strchr("~.HLMNOPRSTuv", ch) && !(ch == 'V' )) {
        // single-char decorations (note letters A-G are NOT in this set)
        i++; continue;
      }
      if (ch == 'V' && i + 1 < text.size() && text[i + 1] == ':') {
        i += 2;
        while (i < text.size() && isspace((unsigned char)text[i])) i++;
        std::string id;
        while (i < text.size() && !isspace((unsigned char)text[i])) id.push_back(text[i++]);
        curVoice = id;
        st = &voice(curVoice);
        continue;
      }
      // inline fields [X:...]
      if (ch == '[' && i + 2 < text.size() && isalpha((unsigned char)text[i + 1]) &&
          text[i + 2] == ':') {
        size_t j = text.find(']', i);
        if (j != std::string::npos) {
          char tag = text[i + 1];
          std::string val = text.substr(i + 3, j - i - 3);
          if (tag == 'M') parseMeter(val);
          else if (tag == 'L') {
            int a, b;
            if (sscanf(val.c_str(), "%d/%d", &a, &b) == 2 && b > 0) {
              unitLen = Frac(a, b);
              unitQl = unitLen * Frac(4);
            }
          } else if (tag == 'K') {
            sharps = keySignatureSharps(val);
            rebuildKeyAcc();
          } else if (tag == 'Q') parseTempo(val);
          else if (tag == 'V') {
            std::string id = val;
            size_t a2 = id.find_first_not_of(" \t");
            size_t b2 = id.find_last_not_of(" \t");
            if (a2 != std::string::npos) id = id.substr(a2, b2 - a2 + 1);
            curVoice = id;
            st = &voice(curVoice);
          }
          i = j + 1;
          continue;
        }
      }
      // volta [1 / [2
      if (ch == '[' && i + 1 < text.size() && isdigit((unsigned char)text[i + 1])) {
        int num = text[i + 1] - '0';
        if (num == 1) {
          st->firstEndingStart = (int)events.size();
          st->firstEndingTime = st->time;
        }
        i += 2;
        continue;
      }
      // bars / repeats
      if (ch == '|' || ch == ':' || ch == '[') {
        bool isRepeatStart = false, isRepeatEnd = false, isBar = false;
        if (match("[|:")) { isRepeatStart = true; isBar = true; }
        else if (match("||:")) { isRepeatStart = true; isBar = true; }
        else if (match("|]")) { isBar = true; }
        else if (match("||")) { isBar = true; }
        else if (match("::")) { isRepeatEnd = true; isRepeatStart = true; isBar = true; }
        else if (match("|:")) { isRepeatStart = true; isBar = true; }
        else if (match(":|]")) { isRepeatEnd = true; isBar = true; }
        else if (match(":|")) { isRepeatEnd = true; isBar = true; }
        else if (match("[|")) { isBar = true; }
        else if (ch == '|') { i++; isBar = true; }
        if (isBar) {
          st->measureAcc.clear();
          st->pendingGraces.clear();  // graces don't cross barlines
          if (isRepeatEnd) expandRepeat(*st, vidx);
          if (isRepeatStart) {
            st->repeatStartIdx = (int)events.size();
            st->repeatStartTime = st->time;
          }
          // '|1' / ':|2' volta spelling: an ending number directly after
          // the barline (equivalent to '[1' / '[2'; parser.py parity)
          if (i < text.size() && isdigit((unsigned char)text[i])) {
            if (text[i] == '1') {
              st->firstEndingStart = (int)events.size();
              st->firstEndingTime = st->time;
            }
            i++;
          }
          continue;
        }
        // plain '[' falls through (chord / unknown)
      }
      // tuplet (p[:q[:r]]
      if (ch == '(' && i + 1 < text.size() && isdigit((unsigned char)text[i + 1]) &&
          text[i + 1] >= '2') {
        int p = text[i + 1] - '0';
        i += 2;
        int q = -1, r = -1;
        if (i < text.size() && text[i] == ':') {
          i++;
          q = 0;
          while (i < text.size() && isdigit((unsigned char)text[i]))
            q = q * 10 + (text[i++] - '0');
          if (q == 0) q = -1;
          if (i < text.size() && text[i] == ':') {
            i++;
            r = 0;
            while (i < text.size() && isdigit((unsigned char)text[i]))
              r = r * 10 + (text[i++] - '0');
            if (r == 0) r = -1;
          }
        }
        int defaultQ = (p == 2 || p == 4 || p == 8) ? 3 : 2;
        if (p == 3 || p == 6) defaultQ = 2;
        int qv = q > 0 ? q : defaultQ;
        int rv = r > 0 ? r : p;
        st->tupletRemaining = rv;
        st->tupletFactor = Frac(qv, p);
        continue;
      }
      if (ch == '(' || ch == ')') { i++; continue; }
      if (ch == '>' || ch == '<') {
        char b = ch;
        int count = 0;
        while (i < text.size() && text[i] == b) { count++; i++; }
        st->pendingBroken = b;
        st->brokenCount = std::min(count, 30);  // 1<<(k+1) UB guard; both
        continue;                               // compilers cap at 30
      }
      if (ch == '-') {
        if (!st->lastGroup.empty()) st->tiePendingIdx = st->lastGroup.back();
        i++;
        continue;
      }
      // chord [CEG]
      if (ch == '[') {
        size_t j = text.find(']', i + 1);
        if (j != std::string::npos) {
          std::string inner = text.substr(i + 1, j - i - 1);
          i = j + 1;
          Frac outerLen = parseLen();  // optional length after ]
          std::vector<std::pair<int, Frac>> chordNotes;
          Frac maxD;
          size_t k = 0;
          while (k < inner.size()) {
            std::string acc;
            size_t after_acc = k;
            if (matchNoteAcc(inner, k, &after_acc, &acc)) {
              k = after_acc;
              char letter = inner[k++];
              int octMarks = 0;
              while (k < inner.size() && (inner[k] == ',' || inner[k] == '\'')) {
                octMarks += (inner[k] == '\'') ? 1 : -1;
                k++;
              }
              Frac innerLen = parseLenAt(inner, k);
              int pitch = notePitch(letter, acc, octMarks, *st);
              Frac d = innerLen * unitQl * outerLen;
              chordNotes.emplace_back(pitch, d);
              if (maxD < d) maxD = d;
            } else {
              k++;
            }
          }
          // tuplet and broken rhythm apply to chords exactly as to
          // single notes (parser.py parity)
          Frac factor(1);
          if (st->tupletRemaining > 0) {
            factor = factor * st->tupletFactor;
            st->tupletRemaining--;
          }
          if (st->pendingBroken) {
            int kb = st->brokenCount;
            Frac fLong((1LL << (kb + 1)) - 1, 1LL << kb);
            Frac fShort(1, 1LL << kb);
            Frac prevF = (st->pendingBroken == '>') ? fLong : fShort;
            Frac thisF = (st->pendingBroken == '>') ? fShort : fLong;
            if (!st->lastGroup.empty()) {
              Frac maxPrev;
              for (int ei : st->lastGroup)
                if (maxPrev < events[ei].dur) maxPrev = events[ei].dur;
              Frac delta = maxPrev * (prevF - Frac(1));
              for (int ei : st->lastGroup)
                events[ei].dur = events[ei].dur * prevF;
              st->time = st->time + delta;
            }
            factor = factor * thisF;
            st->pendingBroken = 0;
            st->brokenCount = 0;
          }
          if (!(factor == Frac(1))) {
            for (auto& cn : chordNotes) cn.second = cn.second * factor;
            maxD = maxD * factor;
          }
          st->tiePendingIdx = -1;  // ties don't bind into chords here
          if (!st->pendingGraces.empty() && !chordNotes.empty()) {
            // same steal rule as single notes: graces take the first 1/4
            // of the chord span, chord scales to 3/4 (parser.py)
            Frac steal = maxD * Frac(kGraceNum, kGraceDen);
            Frac per = steal * Frac(1, (int64_t)st->pendingGraces.size());
            for (int gp : st->pendingGraces) {
              events.push_back({(int32_t)gp, st->time, per, (int32_t)vidx});
              st->time = st->time + per;
            }
            st->pendingGraces.clear();
            Frac scale(kGraceDen - kGraceNum, kGraceDen);
            for (auto& cn : chordNotes) cn.second = cn.second * scale;
            maxD = maxD * scale;
          }
          Frac start = st->time;
          if (!chordNotes.empty()) st->lastGroup.clear();
          for (const auto& [pitch, d] : chordNotes) {
            events.push_back({(int32_t)pitch, start, d, (int32_t)vidx});
            st->lastGroup.push_back((int)events.size() - 1);
          }
          st->time = start + maxD;
          continue;
        }
        i++;
        continue;
      }
      // rest
      if (ch == 'z' || ch == 'x' || ch == 'Z' || ch == 'X') {
        char kind = ch;
        if (kind == 'Z' || kind == 'X') {
          // Z takes an INTEGER bar count. Tokenize like _REST_RE's len
          // group (\d+/\d+|/\d+|\d+|/+): a matched token containing '/'
          // is malformed -> consume ONLY the Z (the token rescans as
          // unknown chars, like Python's int() failure path); pure digits
          // are the bar count. The old scan normalized 'Z4/2' to 2 bars
          // and swallowed 'Z3/' digits Python leaves (review finding).
          size_t k = i + 1;
          Frac len = parseLenAt(text, k);
          bool has_digits = k > i + 1 && isdigit((unsigned char)text[i + 1]);
          bool fractional =
              (k > i + 1) &&
              std::string_view(text).substr(i + 1, k - i - 1).find('/') !=
                  std::string_view::npos;
          if (fractional) {
            i++;  // malformed: skip Z only
            continue;
          }
          i = k;
          Frac bars = has_digits ? len : Frac(1);
          Frac barQl(4LL * meterNum, meterDen);
          emit(-1, barQl * bars, *st, vidx);
        } else {
          i++;
          Frac len = parseLen();
          emit(-1, len * unitQl, *st, vidx);
        }
        continue;
      }
      // note
      {
        std::string acc;
        size_t after_acc = i;
        if (matchNoteAcc(text, i, &after_acc, &acc)) {
          i = after_acc;
          char letter = text[i++];
          int octMarks = 0;
          while (i < text.size() && (text[i] == ',' || text[i] == '\'')) {
            octMarks += (text[i] == '\'') ? 1 : -1;
            i++;
          }
          Frac len = parseLen();
          int pitch = notePitch(letter, acc, octMarks, *st);
          emit(pitch, len * unitQl, *st, vidx);
          continue;
        }
      }
      i++;  // unknown char
    }
  }

  // Render chord-symbol accompaniment on a dedicated voice (parser.py
  // _generate_gchord): the meter's pattern over an eighth-note grid anchored
  // at t=0, fundamental at C2+pc, chord tones at C3+pc+iv, from the first
  // chord symbol to the melody's end.
  void generateGchord() {
    std::string pattern = gchordPattern(meterNum, meterDen);
    std::vector<std::pair<Frac, ParsedChord>> changes;
    std::vector<std::pair<Frac, std::string>> sorted = chordSymbols;
    std::stable_sort(sorted.begin(), sorted.end(),
                     [](const auto& a, const auto& b) { return a.first < b.first; });
    for (const auto& [t, sym] : sorted) {
      ParsedChord pc;
      if (parseChordSymbol(sym, &pc)) changes.emplace_back(t, pc);
    }
    if (pattern.empty() || changes.empty()) return;
    Frac end;
    int maxVoice = -1;
    for (const Event& e : events) {
      Frac e_end = e.start + e.dur;
      if (end < e_end) end = e_end;
      if (e.voice > maxVoice) maxVoice = e.voice;
    }
    int nMelody = (int)(voiceIds.empty() ? 1 : voiceIds.size());
    int voice = nMelody > maxVoice + 1 ? nMelody : maxVoice + 1;
    const Frac slot(1, 2);
    const Frac& first = changes[0].first;
    // k = ceil(first / slot) = ceil(2 * first)
    int64_t k = (2 * first.num + first.den - 1) / first.den;
    if (first.num <= 0) k = 0;
    size_t activeIdx = 0;
    while (true) {
      Frac t = Frac(k) * slot;
      if (!(t < end)) break;
      char c = pattern[(size_t)(k % (int64_t)pattern.size())];
      while (activeIdx + 1 < changes.size() &&
             !(t < changes[activeIdx + 1].first)) {
        activeIdx++;
      }
      const ParsedChord& ch = changes[activeIdx].second;
      if (c == 'f' || c == 'b') {
        int pc = ch.bassPc >= 0 ? ch.bassPc : ch.rootPc;
        events.push_back({(int32_t)(kFundamentalBase + pc), t, slot, (int32_t)voice});
      }
      if (c == 'c' || c == 'b') {
        for (int iv : ch.intervals)
          events.push_back(
              {(int32_t)(kChordBase + ch.rootPc + iv), t, slot, (int32_t)voice});
      }
      k++;
    }
    accompVoice = voice;
  }
};

}  // namespace

extern "C" {

struct AbcEventC {
  int32_t pitch;
  int64_t start_num, start_den;
  int64_t dur_num, dur_den;
  int32_t voice;
};

struct AbcResultC {
  AbcEventC* events;
  int32_t n_events;
  int32_t meter_num, meter_den;
  int32_t sharps;
  double tempo_bpm;
  int64_t unit_num, unit_den;
  int32_t n_voices;
  int32_t accomp_voice;  // -1 = no generated accompaniment
};

AbcResultC* abc_compile_opts(const char* abc_text, int32_t gchord) {
  Parser p;
  std::string body;
  p.parseHeaders(abc_text ? abc_text : "", &body);
  p.parseBody(body);
  if (gchord) p.generateGchord();

  auto* res = (AbcResultC*)calloc(1, sizeof(AbcResultC));
  res->accomp_voice = p.accompVoice;
  res->n_events = (int32_t)p.events.size();
  res->events = (AbcEventC*)calloc(p.events.size() ? p.events.size() : 1,
                                   sizeof(AbcEventC));
  for (size_t k = 0; k < p.events.size(); ++k) {
    const Event& e = p.events[k];
    res->events[k] = {e.pitch, e.start.num, e.start.den, e.dur.num, e.dur.den,
                      e.voice};
  }
  res->meter_num = p.meterNum;
  res->meter_den = p.meterDen;
  res->sharps = p.sharps;
  res->tempo_bpm = p.tempoBpm;
  res->unit_num = p.unitLen.num;
  res->unit_den = p.unitLen.den;
  res->n_voices = (int32_t)(p.voiceIds.empty() ? 1 : p.voiceIds.size());
  return res;
}

AbcResultC* abc_compile(const char* abc_text) {
  return abc_compile_opts(abc_text, 0);
}

void abc_free(AbcResultC* res) {
  if (res) {
    free(res->events);
    free(res);
  }
}

}  // extern "C"
