// Native KDL document parser.
//
// The port's copy of native/kdl.cpp, built by fleetflow_tpu_torch/_ext.py
// (host_library "ffkdl") at its first use.
//
// C++ mirror of core/kdl.py (the executable spec): same
// grammar surface, same lenient bare-word semantics, same int/float
// distinction. The reference parses KDL natively via the Rust kdl crate
// (crates/fleetflow-core/src/parser/*.rs); this keeps our config
// front-end native too: the Python parser's time on a 10k-service fleet
// document dwarfs the placement solve it feeds.
//
// Output is a flat arena exported over the C ABI (preorder node records +
// a shared value array + an interned string buffer); the ctypes side
// (fleetflow_tpu_torch/native/kdl.py) rebuilds KdlNode trees and parity-tests
// against the Python parser over the whole corpus.
//
// Deliberate minor divergences from the Python parser (documented in the
// wrapper, which falls back to Python when they could matter):
//   - integers that overflow int64 signal "unsupported" (rc -2) instead of
//     producing bigints; the wrapper reparses in Python
//   - error line/col are byte-based, Python's are codepoint-based; the
//     wrapper reparses errors in Python so raised KdlErrors are identical
//   - only ASCII digits/alpha satisfy isdigit()/isalpha() lookahead checks

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <cerrno>
#include <cmath>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kMaxDepth = 128;

enum VKind : uint8_t {
    V_NULL = 0, V_FALSE = 1, V_TRUE = 2, V_INT = 3, V_FLOAT = 4, V_STR = 5,
};

struct Value {
    uint8_t kind = V_NULL;
    int64_t i = 0;
    double d = 0.0;
    int32_t soff = -1, slen = 0;   // V_STR payload
    int32_t koff = -1, klen = 0;   // property key; -1 => positional arg
};

struct Node {
    int32_t parent = -1;
    int32_t name_off = 0, name_len = 0;
    int32_t type_off = -1, type_len = 0;
    int32_t val_start = 0;
    int32_t nargs = 0, nprops = 0;
};

struct ParseError {
    std::string msg;
    int64_t pos = 0;
    bool unsupported = false;   // int64 overflow etc. -> Python fallback
};

struct Arena {
    std::vector<Node> nodes;
    std::vector<Value> values;
    std::string strbuf;
    std::unordered_map<std::string, int32_t> intern;

    int32_t put_str(const char* s, size_t len) {
        std::string key(s, len);
        auto it = intern.find(key);
        if (it != intern.end()) return it->second;
        int32_t off = static_cast<int32_t>(strbuf.size());
        strbuf.append(key);
        intern.emplace(std::move(key), off);
        return off;
    }
};

// -- UTF-8 codepoint classification ----------------------------------------

// Decode the codepoint at p (byte index); *cplen = bytes consumed.
// Invalid sequences decode as a single byte (latin-1-ish permissiveness:
// classification only needs to distinguish whitespace/newline/identifier
// membership, and invalid bytes are none of the special classes).
uint32_t decode_cp(const char* t, int64_t n, int64_t p, int* cplen) {
    const unsigned char* s = reinterpret_cast<const unsigned char*>(t);
    unsigned char c = s[p];
    *cplen = 1;
    if (c < 0x80) return c;
    int extra;
    uint32_t cp;
    if ((c & 0xE0) == 0xC0) { extra = 1; cp = c & 0x1F; }
    else if ((c & 0xF0) == 0xE0) { extra = 2; cp = c & 0x0F; }
    else if ((c & 0xF8) == 0xF0) { extra = 3; cp = c & 0x07; }
    else return c;
    if (p + extra >= n) return c;
    for (int k = 1; k <= extra; ++k) {
        unsigned char cc = s[p + k];
        if ((cc & 0xC0) != 0x80) return c;
        cp = (cp << 6) | (cc & 0x3F);
    }
    *cplen = extra + 1;
    return cp;
}

bool is_ws_cp(uint32_t cp) {
    switch (cp) {
        case 0x20: case 0x09: case 0xFEFF: case 0xA0: case 0x1680:
        case 0x202F: case 0x205F: case 0x3000:
            return true;
        default:
            return cp >= 0x2000 && cp <= 0x200A;
    }
}

bool is_newline_cp(uint32_t cp) {
    switch (cp) {
        case 0x0D: case 0x0A: case 0x0C: case 0x85: case 0x2028: case 0x2029:
            return true;
        default:
            return false;
    }
}

bool is_non_identifier_cp(uint32_t cp) {
    switch (cp) {
        case '\\': case '/': case '(': case ')': case '{': case '}':
        case '<': case '>': case ';': case '[': case ']': case '=':
        case ',': case '"':
            return true;
        default:
            return false;
    }
}

void utf8_append(std::string& out, uint32_t cp) {
    // WTF-8: lone surrogates encode like ordinary codepoints; the Python
    // side decodes with errors="surrogatepass" (chr() accepts surrogates)
    if (cp < 0x80) {
        out.push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
        out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
        out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
}

// -- parser -----------------------------------------------------------------

struct Parser {
    const char* text;
    int64_t n;
    int64_t pos = 0;
    int depth = 0;
    Arena arena;
    ParseError err;

    explicit Parser(const char* t, int64_t len) : text(t), n(len) {}

    [[noreturn]] void fail(const std::string& msg) {
        err.msg = msg;
        err.pos = pos;
        throw err;
    }
    [[noreturn]] void fail_unsupported() {
        err.unsupported = true;
        err.pos = pos;
        throw err;
    }

    bool at_end() const { return pos >= n; }
    char peekc(int64_t off = 0) const {
        int64_t i = pos + off;
        return i < n ? text[i] : '\0';
    }
    bool startswith(const char* s) const {
        size_t len = std::strlen(s);
        return pos + static_cast<int64_t>(len) <= n
            && std::memcmp(text + pos, s, len) == 0;
    }

    // classify the codepoint at pos(+byte off impossible: callers use pos)
    uint32_t cp_at(int64_t p, int* len) const {
        return decode_cp(text, n, p, len);
    }

    void skip_block_comment() {
        int64_t start = pos;
        pos += 2;
        int d = 1;
        while (d && pos < n) {
            if (startswith("/*")) { d++; pos += 2; }
            else if (startswith("*/")) { d--; pos += 2; }
            else pos++;
        }
        if (d) { pos = start; fail("unterminated block comment"); }
    }

    void consume_newline() {
        if (startswith("\r\n")) { pos += 2; return; }
        int len;
        if (pos < n && is_newline_cp(cp_at(pos, &len))) pos += len;
    }

    void skip_ws(bool newlines) {
        while (pos < n) {
            int len;
            uint32_t cp = cp_at(pos, &len);
            if (is_ws_cp(cp)) { pos += len; continue; }
            if (startswith("/*")) { skip_block_comment(); continue; }
            if (cp == '\\' && !newlines) {
                int64_t save = pos;
                pos += 1;
                while (pos < n) {
                    int l2; uint32_t c2 = cp_at(pos, &l2);
                    if (!is_ws_cp(c2)) break;
                    pos += l2;
                }
                if (startswith("//")) {
                    while (pos < n) {
                        int l2; uint32_t c2 = cp_at(pos, &l2);
                        if (is_newline_cp(c2)) break;
                        pos += l2;
                    }
                }
                int l3;
                if (pos < n && is_newline_cp(cp_at(pos, &l3))) {
                    consume_newline();
                } else {
                    pos = save;
                    return;
                }
                continue;
            }
            if (newlines && is_newline_cp(cp)) { pos += len; continue; }
            if (newlines && startswith("//")) {
                while (pos < n) {
                    int l2; uint32_t c2 = cp_at(pos, &l2);
                    if (is_newline_cp(c2)) break;
                    pos += l2;
                }
                continue;
            }
            return;
        }
    }

    std::string parse_string() {
        pos += 1;  // opening quote
        std::string out;
        while (true) {
            if (at_end()) fail("unterminated string");
            char c = text[pos];
            if (c == '"') { pos += 1; return out; }
            if (c == '\\') {
                pos += 1;
                char e = peekc();
                switch (e) {
                    case 'n': out.push_back('\n'); pos++; break;
                    case 't': out.push_back('\t'); pos++; break;
                    case 'r': out.push_back('\r'); pos++; break;
                    case '\\': out.push_back('\\'); pos++; break;
                    case '"': out.push_back('"'); pos++; break;
                    case 'b': out.push_back('\b'); pos++; break;
                    case 'f': out.push_back('\f'); pos++; break;
                    case '/': out.push_back('/'); pos++; break;
                    case 's': out.push_back(' '); pos++; break;
                    case 'u': {
                        pos += 1;
                        if (peekc() != '{') fail("expected '{' in \\u escape");
                        pos += 1;
                        std::string hex;
                        while (peekc() != '}') {
                            if (at_end() || hex.size() > 6)
                                fail("bad \\u escape");
                            hex.push_back(text[pos]);
                            pos += 1;
                        }
                        pos += 1;
                        if (hex.empty()) fail("bad \\u escape");
                        errno = 0;
                        char* endp = nullptr;
                        unsigned long long v =
                            std::strtoull(hex.c_str(), &endp, 16);
                        if (errno || endp != hex.c_str() + hex.size()
                                || v > 0x10FFFFull)
                            fail("bad \\u escape");
                        utf8_append(out, static_cast<uint32_t>(v));
                        break;
                    }
                    default:
                        fail(std::string("unknown escape '\\") + e + "'");
                }
            } else {
                out.push_back(c);
                pos += 1;
            }
        }
    }

    std::string parse_raw_string() {
        int64_t start = pos;
        pos += 1;  // 'r'
        int hashes = 0;
        while (peekc() == '#') { hashes++; pos++; }
        if (peekc() != '"') { pos = start; fail("malformed raw string"); }
        pos += 1;
        std::string term = "\"" + std::string(hashes, '#');
        const char* found = nullptr;
        for (int64_t i = pos; i + static_cast<int64_t>(term.size()) <= n; ++i) {
            if (std::memcmp(text + i, term.data(), term.size()) == 0) {
                found = text + i;
                break;
            }
        }
        if (!found) { pos = start; fail("unterminated raw string"); }
        int64_t end = found - text;
        std::string s(text + pos, static_cast<size_t>(end - pos));
        pos = end + static_cast<int64_t>(term.size());
        return s;
    }

    Value parse_number() {
        int64_t start = pos;
        if (peekc() == '+' || peekc() == '-') pos += 1;
        char p0 = peekc(), p1 = peekc(1);
        int base = 10;
        const char* allowed = nullptr;
        if (p0 == '0' && (p1 == 'x' || p1 == 'X')) {
            base = 16; allowed = "0123456789abcdefABCDEF_"; pos += 2;
        } else if (p0 == '0' && (p1 == 'o' || p1 == 'O')) {
            base = 8; allowed = "01234567_"; pos += 2;
        } else if (p0 == '0' && (p1 == 'b' || p1 == 'B')) {
            base = 2; allowed = "01_"; pos += 2;
        }
        Value v;
        if (base == 10) {
            bool seen_e = false;
            while (!at_end()) {
                char c = text[pos];
                if ((c >= '0' && c <= '9') || c == '_') { pos++; }
                else if (c == '.' && peekc(1) >= '0' && peekc(1) <= '9') { pos++; }
                else if ((c == 'e' || c == 'E') && !seen_e) {
                    seen_e = true;
                    pos++;
                    if (peekc() == '+' || peekc() == '-') pos++;
                } else break;
            }
            std::string tok;
            bool is_float = false;
            for (int64_t i = start; i < pos; ++i) {
                char c = text[i];
                if (c == '_') continue;
                if (c == '.' || c == 'e' || c == 'E') is_float = true;
                tok.push_back(c);
            }
            if (is_float) {
                errno = 0;
                char* endp = nullptr;
                double d = std::strtod(tok.c_str(), &endp);
                if (tok.empty() || endp != tok.c_str() + tok.size())
                    fail("bad number '" + tok + "'");
                v.kind = V_FLOAT;
                v.d = d;
            } else {
                errno = 0;
                char* endp = nullptr;
                long long iv = std::strtoll(tok.c_str(), &endp, 10);
                if (tok.empty() || endp != tok.c_str() + tok.size())
                    fail("bad number '" + tok + "'");
                if (errno == ERANGE) fail_unsupported();  // Python bigint
                v.kind = V_INT;
                v.i = iv;
            }
        } else {
            int64_t tok_start = pos;
            while (!at_end() && std::strchr(allowed, text[pos]) != nullptr)
                pos++;
            std::string tok;
            for (int64_t i = tok_start; i < pos; ++i)
                if (text[i] != '_') tok.push_back(text[i]);
            int sign = (text[start] == '-') ? -1 : 1;
            errno = 0;
            char* endp = nullptr;
            long long iv = std::strtoll(tok.c_str(), &endp, base);
            if (tok.empty() || endp != tok.c_str() + tok.size())
                fail("bad number '" + tok + "'");
            if (errno == ERANGE) fail_unsupported();
            v.kind = V_INT;
            v.i = sign * iv;
        }
        return v;
    }

    std::string parse_identifier() {
        int64_t start = pos;
        while (!at_end()) {
            int len;
            uint32_t cp = cp_at(pos, &len);
            if (is_ws_cp(cp) || is_newline_cp(cp) || is_non_identifier_cp(cp))
                break;
            pos += len;
        }
        if (pos == start) fail("expected identifier");
        return std::string(text + start, static_cast<size_t>(pos - start));
    }

    static bool ascii_digit(char c) { return c >= '0' && c <= '9'; }
    static bool ascii_alpha(char c) {
        return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
    }

    bool at_value_start() {
        char c = peekc();
        if (c == '"') return true;
        if (c == 'r' && (peekc(1) == '"' || peekc(1) == '#')) return true;
        if (c == '#' && ascii_alpha(peekc(1))) return true;
        if (ascii_digit(c)) return true;
        if ((c == '+' || c == '-') && ascii_digit(peekc(1))) return true;
        return false;
    }

    Value str_value(const std::string& s) {
        Value v;
        v.kind = V_STR;
        v.soff = arena.put_str(s.data(), s.size());
        v.slen = static_cast<int32_t>(s.size());
        return v;
    }

    Value parse_value() {
        char c = peekc();
        if (c == '"') return str_value(parse_string());
        if (c == 'r' && (peekc(1) == '"' || peekc(1) == '#'))
            return str_value(parse_raw_string());
        if (ascii_digit(c) || ((c == '+' || c == '-') && ascii_digit(peekc(1))))
            return parse_number();
        Value v;
        if (c == '#') {
            pos += 1;
            std::string kw = parse_identifier();
            if (kw == "true") { v.kind = V_TRUE; return v; }
            if (kw == "false") { v.kind = V_FALSE; return v; }
            if (kw == "null") { v.kind = V_NULL; return v; }
            if (kw == "nan") { v.kind = V_FLOAT; v.d = NAN; return v; }
            if (kw == "inf") { v.kind = V_FLOAT; v.d = INFINITY; return v; }
            if (kw == "-inf") { v.kind = V_FLOAT; v.d = -INFINITY; return v; }
            fail("unknown keyword #" + kw);
        }
        std::string ident = parse_identifier();
        if (ident == "true") { v.kind = V_TRUE; return v; }
        if (ident == "false") { v.kind = V_FALSE; return v; }
        if (ident == "null") { v.kind = V_NULL; return v; }
        return str_value(ident);
    }

    // returns whether an annotation was present; *out receives it
    bool parse_type_annotation(std::string* out) {
        if (peekc() != '(') return false;
        pos += 1;
        *out = (peekc() != '"') ? parse_identifier() : parse_string();
        if (peekc() != ')') fail("expected ')' after type annotation");
        pos += 1;
        return true;
    }

    // Parse one node into the arena; returns the node index, or -1 when the
    // node was slash-dash'd (arena nodes/values rolled back; strbuf keeps
    // interned strings, which is only wasted space).
    int32_t parse_node() {
        bool slashdash = false;
        size_t node_mark = arena.nodes.size();
        size_t value_mark = arena.values.size();
        if (startswith("/-")) {
            slashdash = true;
            pos += 2;
            skip_ws(true);
        }
        std::string ty;
        bool has_ty = parse_type_annotation(&ty);
        std::string name =
            (peekc() == '"') ? parse_string() : parse_identifier();

        int32_t idx = static_cast<int32_t>(arena.nodes.size());
        arena.nodes.emplace_back();
        {
            Node& nd = arena.nodes[idx];
            nd.name_off = arena.put_str(name.data(), name.size());
            nd.name_len = static_cast<int32_t>(name.size());
            if (has_ty) {
                nd.type_off = arena.put_str(ty.data(), ty.size());
                nd.type_len = static_cast<int32_t>(ty.size());
            }
        }

        std::vector<Value> args;
        std::vector<Value> props;   // koff/klen set

        bool children = false;
        while (true) {
            skip_ws(false);
            if (at_end()) break;
            int len;
            uint32_t cp = cp_at(pos, &len);
            if (is_newline_cp(cp) || cp == ';') {
                if (cp == ';') pos += 1;
                else consume_newline();
                break;
            }
            if (startswith("//")) {
                while (pos < n) {
                    int l2; uint32_t c2 = cp_at(pos, &l2);
                    if (is_newline_cp(c2)) break;
                    pos += l2;
                }
                continue;
            }
            if (cp == '{') { children = true; break; }
            if (cp == '}') break;

            bool entry_slashdash = false;
            if (startswith("/-")) {
                entry_slashdash = true;
                pos += 2;
                skip_ws(false);
                if (peekc() == '{') {
                    pos += 1;
                    depth += 1;
                    if (depth > kMaxDepth)
                        fail("children nested deeper than 128 levels");
                    size_t nm = arena.nodes.size(), vm = arena.values.size();
                    parse_nodes(true);
                    arena.nodes.resize(nm);     // discard
                    arena.values.resize(vm);
                    depth -= 1;
                    continue;
                }
            }

            if (peekc() == '(') {
                std::string ign;
                parse_type_annotation(&ign);
                Value v = parse_value();
                if (!entry_slashdash) args.push_back(v);
                continue;
            }
            if (at_value_start()) {
                Value v = parse_value();
                if (!entry_slashdash) args.push_back(v);
                continue;
            }

            std::string ident = parse_identifier();
            if (peekc() == '=') {
                pos += 1;
                Value v = parse_value();
                if (!entry_slashdash) {
                    int32_t koff = arena.put_str(ident.data(), ident.size());
                    bool replaced = false;
                    for (Value& pv : props) {
                        if (pv.klen == static_cast<int32_t>(ident.size())
                                && pv.koff == koff) {
                            int32_t ko = pv.koff, kl = pv.klen;
                            pv = v;              // overwrite, keep position
                            pv.koff = ko;
                            pv.klen = kl;
                            replaced = true;
                            break;
                        }
                    }
                    if (!replaced) {
                        v.koff = koff;
                        v.klen = static_cast<int32_t>(ident.size());
                        props.push_back(v);
                    }
                }
            } else if (!entry_slashdash) {
                Value v;
                if (ident == "true") v.kind = V_TRUE;
                else if (ident == "false") v.kind = V_FALSE;
                else if (ident == "null") v.kind = V_NULL;
                else v = str_value(ident);
                args.push_back(v);
            }
        }

        // flush entries (contiguous: args then props)
        {
            Node& nd = arena.nodes[idx];
            nd.val_start = static_cast<int32_t>(arena.values.size());
            nd.nargs = static_cast<int32_t>(args.size());
            nd.nprops = static_cast<int32_t>(props.size());
        }
        arena.values.insert(arena.values.end(), args.begin(), args.end());
        arena.values.insert(arena.values.end(), props.begin(), props.end());

        if (children) {
            pos += 1;  // '{'
            depth += 1;
            if (depth > kMaxDepth)
                fail("children nested deeper than 128 levels");
            parse_children(idx);
            depth -= 1;
        }

        if (slashdash) {
            arena.nodes.resize(node_mark);
            arena.values.resize(value_mark);
            return -1;
        }
        return idx;
    }

    void parse_children(int32_t parent) {
        while (true) {
            skip_ws(true);
            while (peekc() == ';') { pos += 1; skip_ws(true); }
            if (at_end()) fail("unexpected EOF, expected '}'");
            if (peekc() == '}') { pos += 1; return; }
            int32_t child = parse_node();
            if (child >= 0) arena.nodes[child].parent = parent;
        }
    }

    void parse_nodes(bool until_brace) {
        // top level (until_brace=false) or a discarded slash-dash block
        while (true) {
            skip_ws(true);
            while (peekc() == ';') { pos += 1; skip_ws(true); }
            if (at_end()) {
                if (until_brace) fail("unexpected EOF, expected '}'");
                return;
            }
            if (peekc() == '}') {
                if (until_brace) { pos += 1; return; }
                fail("unexpected '}'");
            }
            parse_node();  // top-level nodes keep parent = -1
        }
    }
};

struct Handle {
    Arena arena;
};

void line_col(const char* text, int64_t pos, int32_t* line, int32_t* col) {
    int32_t ln = 1;
    int64_t last = -1;
    for (int64_t i = 0; i < pos; ++i) {
        if (text[i] == '\n') { ln++; last = i; }
    }
    *line = ln;
    *col = static_cast<int32_t>(pos - last);
}

}  // namespace

extern "C" {

// Parse `text[0..len)`. Returns an opaque handle, or nullptr on failure
// with *err_line/*err_col/errbuf describing the error. err_line = -2
// signals "valid-but-unsupported here, reparse in Python" (int64 overflow).
void* ff_kdl_parse(const char* text, int64_t len,
                   char* errbuf, int64_t errbuf_cap,
                   int32_t* err_line, int32_t* err_col) {
    Parser p(text, len);
    try {
        p.parse_nodes(false);
    } catch (const ParseError& e) {
        if (e.unsupported) {
            *err_line = -2;
            *err_col = 0;
        } else {
            line_col(text, e.pos, err_line, err_col);
        }
        if (errbuf_cap > 0) {
            std::snprintf(errbuf, static_cast<size_t>(errbuf_cap), "%s",
                          e.msg.c_str());
        }
        return nullptr;
    } catch (const std::bad_alloc&) {
        *err_line = -2;
        *err_col = 0;
        if (errbuf_cap > 0)
            std::snprintf(errbuf, static_cast<size_t>(errbuf_cap),
                          "out of memory");
        return nullptr;
    }
    Handle* h = new Handle{std::move(p.arena)};
    return h;
}

void ff_kdl_counts(void* handle, int64_t* n_nodes, int64_t* n_values,
                   int64_t* n_strbytes) {
    Handle* h = static_cast<Handle*>(handle);
    *n_nodes = static_cast<int64_t>(h->arena.nodes.size());
    *n_values = static_cast<int64_t>(h->arena.values.size());
    *n_strbytes = static_cast<int64_t>(h->arena.strbuf.size());
}

void ff_kdl_export(void* handle,
                   int32_t* parent, int32_t* name_off, int32_t* name_len,
                   int32_t* type_off, int32_t* type_len,
                   int32_t* val_start, int32_t* nargs, int32_t* nprops,
                   uint8_t* vkind, int64_t* vint, double* vnum,
                   int32_t* vstr_off, int32_t* vstr_len,
                   int32_t* vkey_off, int32_t* vkey_len,
                   char* strbuf) {
    Handle* h = static_cast<Handle*>(handle);
    const Arena& a = h->arena;
    for (size_t i = 0; i < a.nodes.size(); ++i) {
        const Node& nd = a.nodes[i];
        parent[i] = nd.parent;
        name_off[i] = nd.name_off;
        name_len[i] = nd.name_len;
        type_off[i] = nd.type_off;
        type_len[i] = nd.type_len;
        val_start[i] = nd.val_start;
        nargs[i] = nd.nargs;
        nprops[i] = nd.nprops;
    }
    for (size_t i = 0; i < a.values.size(); ++i) {
        const Value& v = a.values[i];
        vkind[i] = v.kind;
        vint[i] = v.i;
        vnum[i] = v.d;
        vstr_off[i] = v.soff;
        vstr_len[i] = v.slen;
        vkey_off[i] = v.koff;
        vkey_len[i] = v.klen;
    }
    if (!a.strbuf.empty())
        std::memcpy(strbuf, a.strbuf.data(), a.strbuf.size());
}

void ff_kdl_free(void* handle) {
    delete static_cast<Handle*>(handle);
}

}  // extern "C"
