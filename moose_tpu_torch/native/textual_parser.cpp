// Parallel chunked parser for the textual computation format.
//
// The reference parses .moose files with a nom grammar sped up by
// rayon-parallel chunking (textual/parsing.rs:83); this is its C++
// equivalent: worker threads each parse a contiguous range of
// lines into a msgpack document which Python decodes at C speed and
// assembles into Operation objects (moose_tpu_torch/textual.py owns the
// grammar's long tail — any attribute value this parser does not fully
// understand is forwarded verbatim as a {"__raw__": "..."} map for the
// Python fallback, so the two parsers always agree).
//
// Per line:  name = Kind{attrs}: (T, ...) -> T (inputs) @Placement[...](owners)
//
// msgpack output: array of {"l": source-line-no, "r": record} where
// record is
//   {"n": name, "k": kind, "a": {key: value|{"__raw__": src}},
//    "it": [type-src, ...], "rt": type-src, "in": [input, ...],
//    "p": placement-src}
// or, for lines that fail structural parsing, {"__line__": src}
// (Python reparses those), keeping this layer purely an accelerator.

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---- minimal msgpack writer ----------------------------------------------

struct Pack {
  std::string buf;
  void u8(uint8_t v) { buf.push_back(static_cast<char>(v)); }
  void big32(uint32_t v) {
    u8(v >> 24); u8(v >> 16); u8(v >> 8); u8(v);
  }
  void array_header(uint32_t n) {
    if (n < 16) u8(0x90 | n);
    else { u8(0xdd); big32(n); }
  }
  void map_header(uint32_t n) {
    if (n < 16) u8(0x80 | n);
    else { u8(0xdf); big32(n); }
  }
  void str(const char* s, size_t len) {
    if (len < 32) u8(0xa0 | static_cast<uint8_t>(len));
    else { u8(0xdb); big32(static_cast<uint32_t>(len)); }
    buf.append(s, len);
  }
  void str(const std::string& s) { str(s.data(), s.size()); }
  void boolean(bool v) { u8(v ? 0xc3 : 0xc2); }
  void nil() { u8(0xc0); }
  void int64(long long v) {
    u8(0xd3);
    for (int i = 7; i >= 0; --i) u8(static_cast<uint8_t>(v >> (8 * i)));
  }
  void f64(double v) {
    u8(0xcb);
    uint64_t bits;
    std::memcpy(&bits, &v, 8);
    for (int i = 7; i >= 0; --i) u8(static_cast<uint8_t>(bits >> (8 * i)));
  }
};

// ---- cursor over one line -------------------------------------------------

struct Cur {
  const char* s;
  size_t n;
  size_t i = 0;
  bool ok = true;

  void ws() { while (i < n && (s[i] == ' ' || s[i] == '\t')) ++i; }
  char peek() { ws(); return i < n ? s[i] : '\0'; }
  bool lit(const char* tok) {
    ws();
    size_t len = std::strlen(tok);
    if (i + len <= n && std::memcmp(s + i, tok, len) == 0) {
      i += len;
      return true;
    }
    ok = false;
    return false;
  }
  static bool ident_start(char c) {
    return std::isalpha(static_cast<unsigned char>(c)) || c == '_';
  }
  static bool ident_char(char c) {
    return std::isalnum(static_cast<unsigned char>(c)) || c == '_' ||
           c == '-' || c == '.';
  }
  std::string ident() {
    ws();
    if (i >= n || !ident_start(s[i])) { ok = false; return ""; }
    size_t start = i;
    while (i < n && ident_char(s[i])) ++i;
    return std::string(s + start, i - start);
  }
  // consume a balanced group assuming the opener is next; returns inner
  std::string balanced(char open, char close) {
    if (!lit(std::string(1, open).c_str())) return "";
    int depth = 1;
    size_t start = i;
    while (i < n) {
      char c = s[i];
      if (c == '"') {
        ++i;
        while (i < n) {
          if (s[i] == '\\') { i += 2; continue; }
          if (s[i] == '"') break;
          ++i;
        }
      } else if (c == open) {
        ++depth;
      } else if (c == close) {
        if (--depth == 0) {
          std::string inner(s + start, i - start);
          ++i;
          return inner;
        }
      }
      ++i;
    }
    ok = false;
    return "";
  }
};

void split_top_level(const std::string& src, char sep,
                     std::vector<std::string>* out) {
  int depth = 0;
  size_t start = 0;
  for (size_t i = 0; i < src.size(); ++i) {
    char c = src[i];
    if (c == '"') {
      ++i;
      while (i < src.size()) {
        if (src[i] == '\\') { i += 2; continue; }
        if (src[i] == '"') break;
        ++i;
      }
    } else if (c == '(' || c == '[' || c == '{') {
      ++depth;
    } else if (c == ')' || c == ']' || c == '}') {
      --depth;
    } else if (c == sep && depth == 0) {
      out->push_back(src.substr(start, i - start));
      start = i + 1;
    }
  }
  if (start < src.size() || !src.empty()) {
    out->push_back(src.substr(start));
  }
}

std::string trim(const std::string& v) {
  size_t a = 0, b = v.size();
  while (a < b && std::isspace(static_cast<unsigned char>(v[a]))) ++a;
  while (b > a && std::isspace(static_cast<unsigned char>(v[b - 1]))) --b;
  return v.substr(a, b - a);
}

// scalar attr values this parser understands natively; anything else is
// forwarded as {"__raw__": src} for the Python grammar
void pack_attr_value(Pack* p, const std::string& raw) {
  std::string v = trim(raw);
  if (v == "true") { p->boolean(true); return; }
  if (v == "false") { p->boolean(false); return; }
  if (v == "null") { p->nil(); return; }
  if (!v.empty() && v.front() == '"' && v.back() == '"' && v.size() >= 2 &&
      v.find('\\') == std::string::npos) {
    p->str(v.data() + 1, v.size() - 2);
    return;
  }
  if (!v.empty() && v.front() == '[' && v.back() == ']') {
    // list of scalars -> recurse; bail to raw on nested complexity
    std::string inner = v.substr(1, v.size() - 2);
    std::vector<std::string> parts;
    if (!trim(inner).empty()) split_top_level(inner, ',', &parts);
    p->array_header(static_cast<uint32_t>(parts.size()));
    for (const auto& part : parts) pack_attr_value(p, part);
    return;
  }
  // 128-bit sync/rendezvous keys print as bare 32-char hex
  // (computation.rs RendezvousKey/SyncKey Display); forward raw so the
  // Python grammar decodes them key-aware as bytes — a digit-only key
  // would otherwise parse as a decimal integer below
  if (v.size() == 32) {
    bool all_hex = true;
    for (char ch : v) {
      if (!std::isxdigit(static_cast<unsigned char>(ch))) {
        all_hex = false;
        break;
      }
    }
    if (all_hex) {
      p->map_header(1);
      p->str("__raw__", 7);
      p->str(v);
      return;
    }
  }
  // integer / float (decimal only: 0x... payloads are bytes in the
  // grammar, and strtod would otherwise read them as hex floats)
  bool numeric_lead =
      !v.empty() &&
      (std::isdigit(static_cast<unsigned char>(v[0])) || v[0] == '-' ||
       v[0] == '+' || v[0] == '.') &&
      !(v.size() >= 2 && v[0] == '0' && (v[1] == 'x' || v[1] == 'X'));
  if (numeric_lead) {
    char* end = nullptr;
    errno = 0;
    long long iv = std::strtoll(v.c_str(), &end, 10);
    bool int_syntax = end && *end == '\0' && end != v.c_str();
    if (int_syntax) {
      if (errno == 0) {
        p->int64(iv);
        return;
      }
      // integer too wide for int64 (ring scalars): forward raw so
      // Python keeps arbitrary precision — never degrade to float
    } else {
      errno = 0;
      double dv = std::strtod(v.c_str(), &end);
      if (errno == 0 && end && *end == '\0' && end != v.c_str()) {
        p->f64(dv);
        return;
      }
    }
  }
  p->map_header(1);
  p->str("__raw__", 7);
  p->str(v);
}

bool parse_line(const std::string& line, Pack* p) {
  Cur c{line.data(), line.size()};
  std::string name = c.ident();
  if (!c.ok || !c.lit("=")) return false;
  std::string kind = c.ident();
  if (!c.ok) return false;

  std::vector<std::pair<std::string, std::string>> attrs;
  if (c.peek() == '{') {
    std::string inner = c.balanced('{', '}');
    if (!c.ok) return false;
    std::vector<std::string> parts;
    if (!trim(inner).empty()) split_top_level(inner, ',', &parts);
    for (const auto& part : parts) {
      size_t eq = std::string::npos;
      int depth = 0;
      for (size_t j = 0; j < part.size(); ++j) {
        char ch = part[j];
        if (ch == '(' || ch == '[' || ch == '{') ++depth;
        else if (ch == ')' || ch == ']' || ch == '}') --depth;
        else if (ch == '=' && depth == 0) { eq = j; break; }
      }
      if (eq == std::string::npos) return false;
      attrs.emplace_back(trim(part.substr(0, eq)),
                         trim(part.substr(eq + 1)));
    }
  }
  if (!c.lit(":")) return false;
  std::string sig_in = c.balanced('(', ')');
  if (!c.ok || !c.lit("->")) return false;
  // return type: everything up to the inputs '(' at depth 0
  c.ws();
  size_t rt_start = c.i;
  int depth = 0;
  while (c.i < c.n) {
    char ch = c.s[c.i];
    if (ch == '<' || ch == '(') {
      if (ch == '(' && depth == 0) break;
      ++depth;
    } else if (ch == '>' || ch == ')') {
      --depth;
    } else if (ch == ' ' && depth == 0) {
      break;
    }
    ++c.i;
  }
  std::string ret_ty = trim(std::string(c.s + rt_start, c.i - rt_start));
  if (ret_ty.empty()) return false;
  std::string inputs_src = c.balanced('(', ')');
  if (!c.ok) return false;
  c.ws();
  std::string placement = trim(line.substr(c.i));
  if (placement.empty() || placement[0] != '@') return false;

  std::vector<std::string> in_tys;
  if (!trim(sig_in).empty()) split_top_level(sig_in, ',', &in_tys);
  std::vector<std::string> inputs;
  if (!trim(inputs_src).empty()) split_top_level(inputs_src, ',', &inputs);

  p->map_header(7);
  p->str("n", 1); p->str(name);
  p->str("k", 1); p->str(kind);
  p->str("a", 1);
  p->map_header(static_cast<uint32_t>(attrs.size()));
  for (const auto& kv : attrs) {
    p->str(kv.first);
    pack_attr_value(p, kv.second);
  }
  p->str("it", 2);
  p->array_header(static_cast<uint32_t>(in_tys.size()));
  for (const auto& t : in_tys) p->str(trim(t));
  p->str("rt", 2); p->str(ret_ty);
  p->str("in", 2);
  p->array_header(static_cast<uint32_t>(inputs.size()));
  for (const auto& v : inputs) p->str(trim(v));
  p->str("p", 1); p->str(placement);
  return true;
}

}  // namespace

extern "C" {

// Parses `text` (len bytes) into a msgpack array of per-line maps using
// `threads` workers (0 = hardware concurrency).  Returns a malloc'd
// buffer (caller frees with mt_parse_free) and writes its size to
// out_len.  Never fails: unparseable lines become {"__line__": src}.
char* mt_parse_textual(const char* text, uint64_t len, int threads,
                       uint64_t* out_len) {
  // split into lines (skip blanks and comments, like the Python parser),
  // keeping 1-based source line numbers for error messages
  struct Line { const char* p; size_t n; uint32_t no; };
  std::vector<Line> lines;
  size_t start = 0;
  uint32_t lineno = 1;
  for (size_t i = 0; i <= len; ++i) {
    if (i == len || text[i] == '\n') {
      size_t a = start, b = i;
      while (a < b && (text[a] == ' ' || text[a] == '\t' ||
                       text[a] == '\r'))
        ++a;
      while (b > a && (text[b - 1] == ' ' || text[b - 1] == '\t' ||
                       text[b - 1] == '\r'))
        --b;
      if (b > a && text[a] != '#' &&
          !(b - a >= 2 && text[a] == '/' && text[a + 1] == '/')) {
        lines.push_back({text + a, b - a, lineno});
      }
      start = i + 1;
      ++lineno;
    }
  }

  int n_threads = threads > 0
      ? threads
      : static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  if (static_cast<size_t>(n_threads) > lines.size() && !lines.empty()) {
    n_threads = static_cast<int>(lines.size());
  }

  std::vector<Pack> packs(std::max(n_threads, 1));
  std::vector<std::thread> workers;
  size_t per = lines.empty() ? 0 : (lines.size() + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      Pack& p = packs[t];
      size_t lo = t * per;
      size_t hi = std::min(lines.size(), lo + per);
      for (size_t j = lo; j < hi; ++j) {
        std::string line(lines[j].p, lines[j].n);
        p.map_header(2);
        p.str("l", 1);
        p.int64(lines[j].no);
        p.str("r", 1);
        Pack attempt;
        if (parse_line(line, &attempt)) {
          p.buf += attempt.buf;
        } else {
          p.map_header(1);
          p.str("__line__", 8);
          p.str(line);
        }
      }
    });
  }
  for (auto& w : workers) w.join();

  Pack head;
  head.array_header(static_cast<uint32_t>(lines.size()));
  size_t total = head.buf.size();
  for (auto& p : packs) total += p.buf.size();
  char* out = static_cast<char*>(std::malloc(total));
  if (out == nullptr) { *out_len = 0; return nullptr; }
  size_t off = 0;
  std::memcpy(out + off, head.buf.data(), head.buf.size());
  off += head.buf.size();
  for (auto& p : packs) {
    std::memcpy(out + off, p.buf.data(), p.buf.size());
    off += p.buf.size();
  }
  *out_len = total;
  return out;
}

void mt_parse_free(char* buf) { std::free(buf); }

}  // extern "C"
