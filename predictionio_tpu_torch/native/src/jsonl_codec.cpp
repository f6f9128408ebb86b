// Native JSON-lines event codec — the host-side data-loader hot path.
//
// Role: the bulk-import / export data plane the reference delegates to
// Spark jobs (tools/.../imprt/FileToEvents.scala:41-103). One pass over
// the file buffer tokenizes each event line, decodes the string fields
// (escape handling included), captures raw JSON slices for
// properties/tags, parses ISO-8601 timestamps to epoch seconds, and
// pre-computes validation facts (empty-properties, reserved property
// keys). Anything the fast path cannot express 1:1 with the Python
// semantics is flagged `fallback` and re-parsed by the Python oracle, so
// the codec can never change behavior — only speed.
//
// The port's copy of predictionio_tpu/native/src/jsonl_codec.cpp,
// unchanged. C ABI only; loaded via ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNumCols = 12;
// Column ids (keep in sync with native/codec.py):
// 0=event 1=entityType 2=entityId 3=targetEntityType 4=targetEntityId
// 5=properties(raw json) 6=tags(raw json) 7=prId 8=eventId
// 9=eventTime(raw) 10=creationTime(raw) 11=badPropertyKey
enum Flag : uint8_t {
  kFallback = 1,       // python must re-parse this line
  kPropsEmpty = 2,     // properties absent/null/{} ($unset validation)
  kBadPropKey = 4,     // a top-level property key has a reserved prefix
};

struct Col {
  std::string data;               // concatenated utf-8
  std::vector<int64_t> offsets;   // row i -> [offsets[i], offsets[i+1])
  std::vector<uint8_t> present;
};

struct Result {
  Col cols[kNumCols];
  std::vector<double> event_time;     // epoch seconds; NaN = absent/unparsed
  std::vector<double> creation_time;
  std::vector<uint8_t> flags;
  std::vector<int64_t> line_start, line_end, lineno;
  int64_t n = 0;

  void begin_row(int64_t ls, int64_t le, int64_t ln) {
    for (auto& c : cols) {
      c.offsets.push_back(static_cast<int64_t>(c.data.size()));
      c.present.push_back(0);
    }
    event_time.push_back(NAN);
    creation_time.push_back(NAN);
    flags.push_back(0);
    line_start.push_back(ls);
    line_end.push_back(le);
    lineno.push_back(ln);
    ++n;
  }
  // set col value for the CURRENT row (duplicate keys: last wins)
  void set(int col, const char* s, size_t len) {
    Col& c = cols[col];
    c.data.resize(static_cast<size_t>(c.offsets.back()));
    c.data.append(s, len);
    c.present.back() = 1;
  }
  void clear_col(int col) {
    Col& c = cols[col];
    c.data.resize(static_cast<size_t>(c.offsets.back()));
    c.present.back() = 0;
  }
  void finish() {
    for (auto& c : cols) c.offsets.push_back(static_cast<int64_t>(c.data.size()));
  }
};

// Hinnant's days-from-civil (public-domain calendrical algorithm).
int64_t days_from_civil(int64_t y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = static_cast<unsigned>(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + static_cast<int64_t>(doe) - 719468;
}

bool parse_uint(const char*& p, const char* end, int digits, int64_t* out) {
  int64_t v = 0;
  for (int i = 0; i < digits; ++i) {
    if (p >= end || *p < '0' || *p > '9') return false;
    v = v * 10 + (*p - '0');
    ++p;
  }
  *out = v;
  return true;
}

// ISO-8601 (datetime.fromisoformat-compatible subset) -> epoch seconds.
// Accepts YYYY-MM-DD[{T| }HH:MM[:SS[.1-6frac]]][±HH:MM]; naive = UTC
// (matching Event.__post_init__'s tz default). Deliberately STRICTER than
// python: anything this rejects falls back to the python parser, so the
// only correctness requirement is that what it accepts, python computes
// identically (callers pre-convert the 'Z' suffix to +00:00).
bool iso_to_epoch(const char* s, size_t len, double* out) {
  const char* p = s;
  const char* end = s + len;
  int64_t Y, M, D, h = 0, mi = 0, sec = 0;
  double frac = 0.0;
  if (!parse_uint(p, end, 4, &Y) || p >= end || *p != '-') return false;
  ++p;
  if (!parse_uint(p, end, 2, &M) || p >= end || *p != '-') return false;
  ++p;
  if (!parse_uint(p, end, 2, &D)) return false;
  if (M < 1 || M > 12 || D < 1) return false;
  static const int kMdays[] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};
  int dmax = kMdays[M - 1];
  if (M == 2 && (Y % 4 == 0 && (Y % 100 != 0 || Y % 400 == 0))) dmax = 29;
  if (D > dmax) return false;
  int64_t tz_off = 0;
  if (p < end) {
    if (*p != 'T' && *p != ' ') return false;
    ++p;
    if (!parse_uint(p, end, 2, &h) || p >= end || *p != ':') return false;
    ++p;
    if (!parse_uint(p, end, 2, &mi)) return false;
    if (p < end && *p == ':') {
      ++p;
      if (!parse_uint(p, end, 2, &sec)) return false;
      if (p < end && *p == '.') {
        ++p;
        double scale = 0.1;
        int nd = 0;
        while (p < end && *p >= '0' && *p <= '9') {
          frac += (*p - '0') * scale;
          scale *= 0.1;
          ++p;
          ++nd;
        }
        if (nd < 1 || nd > 6) return false;
      }
    }
    if (p < end) {
      if (*p == '+' || *p == '-') {
        int sign = (*p == '-') ? -1 : 1;
        ++p;
        int64_t oh, om;
        if (!parse_uint(p, end, 2, &oh)) return false;
        if (p >= end || *p != ':') return false;
        ++p;
        if (!parse_uint(p, end, 2, &om)) return false;
        if (oh > 23 || om > 59) return false;
        tz_off = sign * (oh * 3600 + om * 60);
      }
    }
    if (p != end) return false;
    if (h > 23 || mi > 59 || sec > 59) return false;
  }
  const int64_t days = days_from_civil(Y, static_cast<unsigned>(M),
                                       static_cast<unsigned>(D));
  *out = static_cast<double>(days * 86400 + h * 3600 + mi * 60 + sec - tz_off)
         + frac;
  return true;
}

struct Parser {
  const char* p;
  const char* end;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
  }
  bool lit(const char* s) {
    size_t l = std::strlen(s);
    if (static_cast<size_t>(end - p) < l || std::memcmp(p, s, l) != 0)
      return false;
    p += l;
    return true;
  }

  // Decode a JSON string (incl. \uXXXX with surrogate pairs) to UTF-8.
  bool string(std::string& out) {
    out.clear();
    if (p >= end || *p != '"') return false;
    ++p;
    while (p < end) {
      unsigned char c = static_cast<unsigned char>(*p);
      if (c == '"') {
        ++p;
        return true;
      }
      if (c == '\\') {
        ++p;
        if (p >= end) return false;
        char e = *p++;
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            uint32_t cp;
            if (!hex4(&cp)) return false;
            if (cp >= 0xD800 && cp <= 0xDBFF) {  // high surrogate
              if (p + 1 < end && p[0] == '\\' && p[1] == 'u') {
                p += 2;
                uint32_t lo;
                if (!hex4(&lo)) return false;
                if (lo >= 0xDC00 && lo <= 0xDFFF) {
                  cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
                } else {
                  return false;  // invalid pair: python json would error
                }
              } else {
                // lone surrogate: json.loads ACCEPTS it; we can't encode it
                // as valid UTF-8 — punt to the python path
                return false;
              }
            } else if (cp >= 0xDC00 && cp <= 0xDFFF) {
              return false;  // lone low surrogate: punt
            }
            append_utf8(out, cp);
            break;
          }
          default: return false;
        }
      } else if (c < 0x20) {
        return false;  // control chars must be escaped
      } else {
        out += static_cast<char>(c);
        ++p;
      }
    }
    return false;
  }

  bool hex4(uint32_t* out) {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      if (p >= end) return false;
      char c = *p++;
      v <<= 4;
      if (c >= '0' && c <= '9') v |= c - '0';
      else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
      else return false;
    }
    *out = v;
    return true;
  }

  static void append_utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
      out += static_cast<char>(cp);
    } else if (cp < 0x800) {
      out += static_cast<char>(0xC0 | (cp >> 6));
      out += static_cast<char>(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += static_cast<char>(0xE0 | (cp >> 12));
      out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      out += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      out += static_cast<char>(0xF0 | (cp >> 18));
      out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
      out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      out += static_cast<char>(0x80 | (cp & 0x3F));
    }
  }

  bool skip_string() {
    std::string tmp;  // decoding validates escapes exactly
    return string(tmp);
  }

  bool number(const char** s, const char** e) {
    const char* start = p;
    if (p < end && *p == '-') ++p;
    if (p >= end || *p < '0' || *p > '9') return false;
    while (p < end && *p >= '0' && *p <= '9') ++p;
    if (p < end && *p == '.') {
      ++p;
      if (p >= end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p;
      if (p < end && (*p == '+' || *p == '-')) ++p;
      if (p >= end || *p < '0' || *p > '9') return false;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    *s = start;
    *e = p;
    return true;
  }

  // Skip any JSON value, returning its raw [start,end) slice.
  bool skip_value(const char** s, const char** e) {
    ws();
    *s = p;
    if (p >= end) return false;
    char c = *p;
    if (c == '"') {
      if (!skip_string()) return false;
    } else if (c == '{') {
      ++p;
      ws();
      if (p < end && *p == '}') {
        ++p;
      } else {
        while (true) {
          ws();
          if (!skip_string()) return false;
          ws();
          if (p >= end || *p != ':') return false;
          ++p;
          const char *vs, *ve;
          if (!skip_value(&vs, &ve)) return false;
          ws();
          if (p < end && *p == ',') {
            ++p;
            continue;
          }
          if (p < end && *p == '}') {
            ++p;
            break;
          }
          return false;
        }
      }
    } else if (c == '[') {
      ++p;
      ws();
      if (p < end && *p == ']') {
        ++p;
      } else {
        while (true) {
          const char *vs, *ve;
          if (!skip_value(&vs, &ve)) return false;
          ws();
          if (p < end && *p == ',') {
            ++p;
            continue;
          }
          if (p < end && *p == ']') {
            ++p;
            break;
          }
          return false;
        }
      }
    } else if (c == 't') {
      if (!lit("true")) return false;
    } else if (c == 'f') {
      if (!lit("false")) return false;
    } else if (c == 'n') {
      if (!lit("null")) return false;
    } else {
      const char *ns, *ne;
      if (!number(&ns, &ne)) return false;
    }
    *e = p;
    return true;
  }
};

bool reserved_prefix(const std::string& k) {
  return (!k.empty() && k[0] == '$') || k.rfind("pio_", 0) == 0;
}

// Parse the `properties` object: raw slice + emptiness + reserved-key scan.
// Returns false on malformed JSON (caller marks fallback).
bool parse_properties(Parser& pr, Result& res) {
  pr.ws();
  if (pr.p < pr.end && *pr.p == 'n') {  // null -> treated as {}
    if (!pr.lit("null")) return false;
    res.set(5, "{}", 2);
    res.flags.back() |= kPropsEmpty;
    return true;
  }
  if (pr.p >= pr.end || *pr.p != '{') return false;  // non-object: fallback
  const char* start = pr.p;
  ++pr.p;
  pr.ws();
  bool empty = true;
  std::string key;
  if (pr.p < pr.end && *pr.p == '}') {
    ++pr.p;
  } else {
    while (true) {
      pr.ws();
      if (!pr.string(key)) return false;
      empty = false;
      if (reserved_prefix(key)) {
        res.flags.back() |= kBadPropKey;
        res.set(11, key.data(), key.size());
      }
      pr.ws();
      if (pr.p >= pr.end || *pr.p != ':') return false;
      ++pr.p;
      const char *vs, *ve;
      if (!pr.skip_value(&vs, &ve)) return false;
      pr.ws();
      if (pr.p < pr.end && *pr.p == ',') {
        ++pr.p;
        continue;
      }
      if (pr.p < pr.end && *pr.p == '}') {
        ++pr.p;
        break;
      }
      return false;
    }
  }
  res.set(5, start, static_cast<size_t>(pr.p - start));
  if (empty) res.flags.back() |= kPropsEmpty;
  return true;
}

int key_to_col(const std::string& k) {
  if (k == "event") return 0;
  if (k == "entityType") return 1;
  if (k == "entityId") return 2;
  if (k == "targetEntityType") return 3;
  if (k == "targetEntityId") return 4;
  if (k == "prId") return 7;
  if (k == "eventId") return 8;
  return -1;
}

// Parse one event line into the current row; false -> fallback.
bool parse_line(const char* s, const char* e, Result& res) {
  Parser pr{s, e};
  pr.ws();
  if (pr.p >= pr.end || *pr.p != '{') return false;
  ++pr.p;
  pr.ws();
  if (pr.p < pr.end && *pr.p == '}') {
    ++pr.p;
  } else {
    std::string key, val;
    while (true) {
      pr.ws();
      if (!pr.string(key)) return false;
      pr.ws();
      if (pr.p >= pr.end || *pr.p != ':') return false;
      ++pr.p;
      pr.ws();
      int col = key_to_col(key);
      if (col >= 0) {
        if (pr.p < pr.end && *pr.p == '"') {
          if (!pr.string(val)) return false;
          res.set(col, val.data(), val.size());
        } else if (pr.p < pr.end && *pr.p == 'n') {
          if (!pr.lit("null")) return false;
          // null optional field = absent; null REQUIRED field would make
          // python str(None) -> "None"; that's a validation oddity, punt
          if (col <= 2) return false;
          res.clear_col(col);
        } else if (col <= 2 && pr.p < pr.end &&
                   ((*pr.p >= '0' && *pr.p <= '9') || *pr.p == '-')) {
          // python str()-coerces event/entityType/entityId; an int literal
          // renders identically, floats/exponents may not — ints only
          const char *ns, *ne;
          if (!pr.number(&ns, &ne)) return false;
          for (const char* q = ns; q != ne; ++q)
            if (*q == '.' || *q == 'e' || *q == 'E') return false;
          res.set(col, ns, static_cast<size_t>(ne - ns));
        } else {
          return false;  // unexpected type: python path decides
        }
      } else if (key == "properties") {
        if (!parse_properties(pr, res)) return false;
      } else if (key == "tags") {
        pr.ws();
        if (pr.p < pr.end && *pr.p == 'n') {
          if (!pr.lit("null")) return false;
          res.set(6, "[]", 2);
        } else if (pr.p < pr.end && *pr.p == '[') {
          const char *vs, *ve;
          if (!pr.skip_value(&vs, &ve)) return false;
          res.set(6, vs, static_cast<size_t>(ve - vs));
        } else {
          return false;
        }
      } else if (key == "eventTime" || key == "creationTime") {
        const bool is_event = key[0] == 'e';
        pr.ws();
        double* slot = is_event ? &res.event_time.back()
                                : &res.creation_time.back();
        int raw_col = is_event ? 9 : 10;
        if (pr.p < pr.end && *pr.p == '"') {
          if (!pr.string(val)) return false;
          res.set(raw_col, val.data(), val.size());
          double t;
          std::string v = val;
          if (!v.empty() && v.back() == 'Z') v.pop_back(), v += "+00:00";
          if (iso_to_epoch(v.data(), v.size(), &t)) *slot = t;
          // unparsed: stays NaN with raw present -> python re-parses
        } else if (pr.p < pr.end && *pr.p == 'n') {
          if (!pr.lit("null")) return false;
          res.clear_col(raw_col);
        } else if (pr.p < pr.end &&
                   ((*pr.p >= '0' && *pr.p <= '9') || *pr.p == '-')) {
          const char *ns, *ne;
          if (!pr.number(&ns, &ne)) return false;
          *slot = std::strtod(std::string(ns, ne).c_str(), nullptr) / 1000.0;
          res.set(raw_col, ns, static_cast<size_t>(ne - ns));
        } else {
          return false;
        }
      } else {
        const char *vs, *ve;
        if (!pr.skip_value(&vs, &ve)) return false;
      }
      pr.ws();
      if (pr.p < pr.end && *pr.p == ',') {
        ++pr.p;
        continue;
      }
      if (pr.p < pr.end && *pr.p == '}') {
        ++pr.p;
        break;
      }
      return false;
    }
  }
  pr.ws();
  if (pr.p != pr.end) return false;  // trailing garbage
  // required fields must be present (missing -> python raises the
  // precise "field 'X' is required" error)
  if (!res.cols[0].present.back() || !res.cols[1].present.back() ||
      !res.cols[2].present.back())
    return false;
  return true;
}

}  // namespace

extern "C" {

void* pio_jsonl_parse(const char* buf, int64_t len) {
  auto* res = new Result();
  const char* p = buf;
  const char* end = buf + len;
  int64_t lineno = 0;
  while (p < end) {
    const char* nl = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* le = nl ? nl : end;
    ++lineno;
    // skip blank lines (matches import's `if not line.strip(): continue`)
    const char* q = p;
    while (q < le && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
    if (q != le) {
      res->begin_row(p - buf, le - buf, lineno);
      // snapshot column sizes so a half-written row can be rolled back
      size_t saved[kNumCols];
      for (int c = 0; c < kNumCols; ++c) saved[c] = res->cols[c].data.size();
      if (!parse_line(p, le, *res)) {
        for (int c = 0; c < kNumCols; ++c) {
          res->cols[c].data.resize(
              static_cast<size_t>(res->cols[c].offsets.back()));
          res->cols[c].present.back() = 0;
        }
        (void)saved;
        res->event_time.back() = NAN;
        res->creation_time.back() = NAN;
        res->flags.back() = kFallback;
      }
    }
    if (!nl) break;
    p = nl + 1;
  }
  res->finish();
  return res;
}

int64_t pio_jsonl_count(void* h) { return static_cast<Result*>(h)->n; }

int64_t pio_jsonl_col_bytes(void* h, int32_t col) {
  return static_cast<int64_t>(static_cast<Result*>(h)->cols[col].data.size());
}

void pio_jsonl_col_fill(void* h, int32_t col, char* data, int64_t* offsets,
                        uint8_t* present) {
  Col& c = static_cast<Result*>(h)->cols[col];
  if (!c.data.empty()) std::memcpy(data, c.data.data(), c.data.size());
  std::memcpy(offsets, c.offsets.data(), c.offsets.size() * sizeof(int64_t));
  if (!c.present.empty())
    std::memcpy(present, c.present.data(), c.present.size());
}

void pio_jsonl_times(void* h, double* et, double* ct) {
  Result* r = static_cast<Result*>(h);
  std::memcpy(et, r->event_time.data(), r->event_time.size() * sizeof(double));
  std::memcpy(ct, r->creation_time.data(),
              r->creation_time.size() * sizeof(double));
}

void pio_jsonl_flags(void* h, uint8_t* flags) {
  Result* r = static_cast<Result*>(h);
  std::memcpy(flags, r->flags.data(), r->flags.size());
}

void pio_jsonl_lines(void* h, int64_t* start, int64_t* end, int64_t* lineno) {
  Result* r = static_cast<Result*>(h);
  std::memcpy(start, r->line_start.data(), r->line_start.size() * 8);
  std::memcpy(end, r->line_end.data(), r->line_end.size() * 8);
  std::memcpy(lineno, r->lineno.data(), r->lineno.size() * 8);
}

void pio_jsonl_free(void* h) { delete static_cast<Result*>(h); }

// Dictionary-encode one string column: per-row int32 codes in
// first-seen label order (-1 where the column is absent) plus the
// distinct label blob. This is the ingest fast lane that lets training
// reads skip materializing one Python string per row — at 10M+ events
// the per-row str construction dominates the whole read.
struct DictResult {
  std::vector<int32_t> codes;
  std::string blob;               // concatenated distinct labels
  std::vector<int64_t> offsets;   // label k -> [offsets[k], offsets[k+1])
};

void* pio_jsonl_dict_encode(void* h, int32_t col) {
  Result* r = static_cast<Result*>(h);
  const Col& c = r->cols[col];
  auto* d = new DictResult();
  d->codes.resize(static_cast<size_t>(r->n));
  d->offsets.push_back(0);
  std::unordered_map<std::string_view, int32_t> map;
  map.reserve(1024);
  for (int64_t i = 0; i < r->n; ++i) {
    if (!c.present[static_cast<size_t>(i)]) {
      d->codes[static_cast<size_t>(i)] = -1;
      continue;
    }
    std::string_view sv(
        c.data.data() + c.offsets[static_cast<size_t>(i)],
        static_cast<size_t>(c.offsets[static_cast<size_t>(i) + 1] -
                            c.offsets[static_cast<size_t>(i)]));
    auto it = map.find(sv);
    int32_t code;
    if (it == map.end()) {
      code = static_cast<int32_t>(map.size());
      map.emplace(sv, code);
      d->blob.append(sv);
      d->offsets.push_back(static_cast<int64_t>(d->blob.size()));
    } else {
      code = it->second;
    }
    d->codes[static_cast<size_t>(i)] = code;
  }
  return d;
}

int64_t pio_dict_n_labels(void* d) {
  return static_cast<int64_t>(
      static_cast<DictResult*>(d)->offsets.size() - 1);
}

int64_t pio_dict_blob_bytes(void* d) {
  return static_cast<int64_t>(static_cast<DictResult*>(d)->blob.size());
}

void pio_dict_fill(void* dh, int32_t* codes, char* blob, int64_t* offsets) {
  DictResult* d = static_cast<DictResult*>(dh);
  if (!d->codes.empty())
    std::memcpy(codes, d->codes.data(), d->codes.size() * sizeof(int32_t));
  if (!d->blob.empty()) std::memcpy(blob, d->blob.data(), d->blob.size());
  std::memcpy(offsets, d->offsets.data(),
              d->offsets.size() * sizeof(int64_t));
}

void pio_dict_free(void* d) { delete static_cast<DictResult*>(d); }

// Extract one top-level numeric property per row from the raw
// `properties` slices — the training-ingest value column (e.g. "rating")
// without any per-row Python JSON parsing. Per row:
//   status 0 = key absent or JSON null (caller applies default_value)
//   status 1 = numeric; out[i] holds the value
//   status 2 = present but non-numeric (bool/string/object/array —
//              python's isinstance((int,float)) excludes bool)
// Duplicate keys follow json.loads last-wins. Rows whose properties the
// main parse could not express (fallback / absent) report status 0; the
// caller's fallback path re-parses those lines wholesale anyway.
void pio_jsonl_extract_numeric(void* h, const char* key, int64_t keylen,
                               double* out, uint8_t* status) {
  Result* r = static_cast<Result*>(h);
  const Col& c = r->cols[5];
  const std::string want(key, static_cast<size_t>(keylen));
  std::string k;
  for (int64_t i = 0; i < r->n; ++i) {
    out[i] = NAN;
    status[i] = 0;
    if (!c.present[static_cast<size_t>(i)]) continue;
    Parser pr{c.data.data() + c.offsets[static_cast<size_t>(i)],
              c.data.data() + c.offsets[static_cast<size_t>(i) + 1]};
    pr.ws();
    if (pr.p >= pr.end || *pr.p != '{') continue;
    ++pr.p;
    pr.ws();
    if (pr.p < pr.end && *pr.p == '}') continue;
    while (true) {
      pr.ws();
      if (!pr.string(k)) break;
      pr.ws();
      if (pr.p >= pr.end || *pr.p != ':') break;
      ++pr.p;
      pr.ws();
      if (k == want) {
        if (pr.p < pr.end &&
            ((*pr.p >= '0' && *pr.p <= '9') || *pr.p == '-')) {
          const char *ns, *ne;
          if (!pr.number(&ns, &ne)) break;
          out[i] = std::strtod(std::string(ns, ne).c_str(), nullptr);
          status[i] = 1;
        } else if (pr.p < pr.end && *pr.p == 'n') {
          if (!pr.lit("null")) break;
          out[i] = NAN;
          status[i] = 0;
        } else {
          const char *vs, *ve;
          if (!pr.skip_value(&vs, &ve)) break;
          out[i] = NAN;
          status[i] = 2;
        }
      } else {
        const char *vs, *ve;
        if (!pr.skip_value(&vs, &ve)) break;
      }
      pr.ws();
      if (pr.p < pr.end && *pr.p == ',') {
        ++pr.p;
        continue;
      }
      break;
    }
  }
}

}  // extern "C"
