"""The port's KDL parser (fleetflow_tpu_torch.core.kdl) against the
reference's (fleetflow_tpu.core.kdl) on the reference's parser corpus.

Every case feeds the same text to both packages' ``parse_document`` (each
with its native fast path on) and to both pure-Python parsers, and holds
the port to the reference: the same node trees (names, argument and
property values with their int/float/bool/None types, type annotations,
children), the same ``format_document`` text, and on malformed input the
same KdlError message, line and column. Exact: tolerance 0.
"""

import pytest

from fleetflow_tpu.core import kdl as ref_kdl
from fleetflow_tpu_torch.core import kdl as port_kdl


def _norm(v):
    """NaN never equals itself: map it to a sentinel. Pin the type too
    (True == 1 == 1.0 in Python, and all three must stay apart)."""
    if isinstance(v, float) and v != v:
        return "<nan>"
    return (type(v).__name__, v)


def tree(nodes):
    """Structural projection of a KdlNode list (either package's)."""
    return [(n.name, [_norm(a) for a in n.args],
             {k: _norm(v) for k, v in n.props.items()},
             n.type_annotation, tree(n.children)) for n in nodes]


def outcome(parse, text):
    """("ok", tree) or ("error", class name, message, line, col)."""
    try:
        return ("ok", tree(parse(text)))
    except ValueError as e:
        return ("error", type(e).__name__, str(e), getattr(e, "line", None),
                getattr(e, "col", None))


# valid documents: the reference's test_kdl.py and test_native_kdl.py
# corpora (the full grammar surface of core/kdl.py)
VALID = [
    "", "\n\n  \n", "node", 'service "postgres" "extra"',
    "nums 1 -2 3.5 1e3 0x1F 0o17 0b101 1_000_000",
    "nums +7 -0x10 -0o7 -0b11 2.5e-3 1E+2 1_0.5_0",
    "kw true false null", "kw #true #false #null #inf #nan",
    'port host=8080 container=80 protocol="udp"',
    'volume "./data" "/data" read-only=true', "a; b; c", "a;; b ;\n c",
    '"weird name" 1',
    'service "db" {\n  image "postgres"\n  version "16"\n}',
    "a { b { c { d 1 } } }", "a { b 1; c 2 }",
    "ports { port host=1 container=2 }",
    'cap { cpu 4 } labels { tier "web" }', "inline { x 1; y 2 }",
    "// comment\nnode 1 // trailing\n", "// hi\nnode 1 // trailing\nother",
    "/* block */ node /* mid */ 1", "node /* inline */ 1 /* another */ 2",
    "/* nested /* deeper */ still */ node",
    "/-node 1 2 { child }\nkept", "/- node-with-space 1\nkept",
    "/-dead { child 1 }\nalive", 'node /-"dead" "alive"',
    "node /-dead=1 live=2", "a /-1 2", "a /-k=1 j=2",
    "a /-{ discarded 1 } b=2", "a /- (t)5 b=2", 'a /- (t)"s" 1',
    'esc "a\\nb\\tc\\\\d\\"e\\s"', 'uni "\\u{1F600}\\u{41}"',
    'raw r"no\\escape"', 'raw r#"has "quotes" inside"#',
    'raw r##"deep "# inside"##', 'cmd r#"echo "hi""#',
    r'cmd "say \"hi\"\n\tdone"',
    "multi 1 \\\n  2 \\  // comment after continuation\n  3",
    'node 1 \\\n  2 3', 'node 1 \\ // comment\n  2', 'node \\\n  "arg"',
    "crlf 1\r\nnext 2\r\n", "tabs\t1\t\tk=2",
    'node\t"a"\t{\r\n\tchild "x"\r\n}\r\n',
    "(ty)node 1", '("quoted ty")node 1', "n (u8)1 (f)2.5 (s)\"x\"",
    '(author)node "x"', 'port (u16)8080 (string)"x"',
    "dup k=1 k=2 k=3", "bare word-arg under_score dotted.name",
    'unicode-strings "データベース" name="日本語"',
    'サービス "値" key="日本語"', 'node "日本語のサービス"',
    "﻿bom-doc 1", "nbsp arg", "u2028 next",
    "deep" + " { x" * 100 + " 1" + " }" * 100,
    "a {" * 100 + "}" * 100,
    "semi-only ;;;", "empty-children {}",
    "children-then-sibling { a 1 } sibling 2",
    "ints 0 -0 9223372036854775807 -9223372036854775808",
    "floats 0.0 -0.5 3.14159 1e0 1e-0",
    "big 9223372036854775808 -9223372036854775809 123456789012345678901",
    'env url="http://x#frag" tmpl="{not-a-block}"',
    'vals true false null 42 -5 3.14 1e3',
    'server "a" { capacity { cpu 4 } labels { t "x" } }',
    '/-dead "node"\nlive "a" /-"dead-arg" "keep" /-{ gone "x" }',
    '// line\na "1" /* inline */ "2"\n/* multi\nline */\nb "3"',
    'x "٣ in a string"',
]

# malformed documents: each must raise the same KdlError in both packages
INVALID = [
    "a {", "a }", "/* oops", 'node "oops', 'svc "a', 'svc r#"abc',
    'svc "a" {', "}", "/* foo", "port host=", "a {" * 2000 + "}" * 2000,
    "node 0x", "n #bogus", "n k=", "n (t", 'n "\\q"',
    'n "\\u{110000}"', "n 1.2.3", "a \\ b", "(t)", "n =1", "a ٣", "a #é",
]

REFERENCE_CONFIG = '''
project "fleetflow-services"

provider "sakura-cloud" { zone "tk1a" }

server "fleetflow-cp" {
    provider "sakura-cloud"
    plan "2core-4gb"
    disk-size 40
    tags "fleetflow:cp"
}

service "fleetflowd" {
    image "ghcr.io/example/fleetflowd:latest"
    restart "unless-stopped"
    ports {
        port host=4510 container=4510
        port host=32080 container=32080
    }
    volumes {
        volume "/etc/fleetflow" "/etc/fleetflow" read-only=true
    }
    env {
        RUST_LOG "info"
    }
}

stage "live" {
    server "fleetflow-cp"
    service "fleetflowd"
}
'''


@pytest.mark.parametrize("text", VALID + [REFERENCE_CONFIG])
def test_valid_document_parity(text):
    want = outcome(ref_kdl.parse_document, text)
    assert want[0] == "ok", want
    assert outcome(port_kdl.parse_document, text) == want
    assert outcome(lambda t: port_kdl._Parser(t).parse_nodes(), text) == want


@pytest.mark.parametrize("text", INVALID, ids=range(len(INVALID)))
def test_invalid_document_parity(text):
    want = outcome(ref_kdl.parse_document, text)
    assert want[0] == "error" and want[1] == "KdlError", want
    got = outcome(port_kdl.parse_document, text)
    assert got == want
    with pytest.raises(port_kdl.KdlError):
        port_kdl.parse_document(text)


@pytest.mark.parametrize("text", [
    'service "db" { image "postgres"; ports { port host=1 container=2 } }',
    REFERENCE_CONFIG, "kw #true #false #null 1.5 -3 x=\"a\\\"b\\nc\"",
    '"weird name" 1 { "child node" k="v" }'])
def test_format_document_parity(text):
    ref_text = ref_kdl.format_document(ref_kdl.parse_document(text))
    port_text = port_kdl.format_document(port_kdl.parse_document(text))
    assert port_text == ref_text
    # the formatted text parses back to the same tree
    assert tree(port_kdl.parse_document(port_text)) == \
        tree(port_kdl.parse_document(text))


def test_spans_parity():
    """want_spans: the same 1-based positions, shifted by line_offset."""
    for offset in (0, 7):
        ref = ref_kdl.parse_document(REFERENCE_CONFIG, want_spans=True,
                                     line_offset=offset)
        port = port_kdl.parse_document(REFERENCE_CONFIG, want_spans=True,
                                       line_offset=offset)

        def spans(nodes):
            return [(n.name, n.line, n.col, spans(n.children))
                    for n in nodes]
        assert spans(port) == spans(ref)
        assert spans(port)[0][1] == 2 + offset


def test_error_line_offset_parity():
    for text in ('a {\n  b "x\n', "ok 1\nbad }\n"):
        want = outcome(lambda t: ref_kdl.parse_document(
            t, line_offset=10), text)
        assert outcome(lambda t: port_kdl.parse_document(
            t, line_offset=10), text) == want


def test_node_helpers():
    """KdlNode's accessors, as the reference's tests use them."""
    (svc,) = [n for n in port_kdl.parse_document(REFERENCE_CONFIG)
              if n.name == "service"]
    assert len(list(svc.child("ports").children_named("port"))) == 2
    assert svc.child("image").arg(0) == "ghcr.io/example/fleetflowd:latest"
    assert svc.child("nothing") is None
    (n,) = port_kdl.parse_document('env url="http://x#frag" k=1')
    assert n.prop("url") == "http://x#frag" and n.prop("missing") is None
    with pytest.raises(port_kdl.KdlError, match="nested deeper"):
        port_kdl.parse_document("a {" * 2000 + "}" * 2000)


def test_kdl_error_pickles():
    """Parse errors cross the loader's process pool."""
    import pickle
    try:
        port_kdl.parse_document('svc "a')
    except port_kdl.KdlError as e:
        back = pickle.loads(pickle.dumps(e))
        assert (back.message, back.line, back.col, str(back)) == \
            (e.message, e.line, e.col, str(e))


@pytest.mark.parametrize("value", [True, "true", "TRUE", " yes ", "on", "1",
                                   1, False, "false", "FALSE", " no ", "off",
                                   "0", "", 0, None, "flase", "disable",
                                   "enabled", "ture", "none"])
def test_bool_value_parity(value):
    def run(fn):
        try:
            return ("ok", fn(value))
        except ValueError as e:
            return ("error", str(e))
    assert run(port_kdl.bool_value) == run(ref_kdl.bool_value)
