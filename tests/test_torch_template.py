"""The port's templating, dotenv, variables pre-pass and 1Password secret
references (fleetflow_tpu_torch.core.template / .secrets) against the
reference's, on the reference's template cases.

Each case runs the same input through both packages and compares the
output, or the error class and message. The `op` CLI is a script on PATH
that prints what it was asked for, so ``resolve_reference`` runs its real
subprocess call in both packages.
"""

import os
import stat

import pytest

from fleetflow_tpu.core import secrets as ref_secrets
from fleetflow_tpu.core import template as ref_tpl
from fleetflow_tpu_torch.core import secrets as port_secrets
from fleetflow_tpu_torch.core import template as port_tpl
from fleetflow_tpu_torch.core.errors import FlowError
from torch_frontend_cases import run

DOTENV = [
    "A=1\nB=two\n# comment\n\nC=three four",
    'export A="quoted value"\nB=\'single\'\nC=bare # trailing',
    "not a kv line\nA=1", "", "=novalue\nK=\nQ=\"unterminated",
    "A=1\nA=2\nexport  B = spaced ", "URL=http://x/#frag",
]

# (variables, template, strict)
RENDER = [
    ({"VERSION": "1.2.3"}, 'image "app:{{ VERSION }}"', True),
    ({"X": "high"}, "{{ X }}", True),
    ({}, "{{ NOPE }}", True),
    ({"SET": "v"}, '{{ SET | default(value="d") }}', True),
    ({}, '{{ UNSET | default("d") }}', False),
    ({}, '{{ UNSET | default(value="d") }}', False),
    ({}, 'image "app:${APP_VERSION:-latest}"', True),
    ({"STAGE": "live"},
     '{% if STAGE == "live" %}prod{% else %}dev{% endif %}', True),
    ({}, '{{ env(name="FLEET_TPL_TEST_VAR") }}', True),
    ({}, '{{ env(name="FLEET_TPL_MISSING", default="d") }}', True),
    ({}, '{{ env(name="FLEET_TPL_MISSING") }}', True),
    ({}, "{% if %}", True),
    ({"N": "3"}, "{% for i in range(N | int) %}s{{ i }} {% endfor %}",
     True),
    ({"A": "x"}, "service \"{{ A }}\" {\n  image \"{{ A | upper }}\"\n}",
     True),
]

VARIABLES_TEXT = '''
variables {
    GLOBAL "g"
    SHARED "top"
}
service "a" { image "x:{{ GLOBAL }}" }
stage "dev" {
    variables {
        SHARED "dev-wins"
        DEV_ONLY "d"
    }
}
stage "live" {
    variables { SHARED "live-wins" }
}
'''

PREPASS = [
    (VARIABLES_TEXT, None), (VARIABLES_TEXT, "dev"),
    (VARIABLES_TEXT, "live"), (VARIABLES_TEXT, "missing"),
    ('variables { V "1" }\nservice "a" { image "{{ V }}" }\n'
     '{% if x %}{% endif %}', None),
    ('variables { BASE_URL "https://example.com/x" }', None),
    ('variables { A "1"; B 2 }\nvariables { A "3" }', None),
    ("no variables here", "dev"),
]

OP_REFS = ["op://vault/item/field", "op://v/i/f/extra", "op://vault/item",
           "not-a-ref", "", "op:///item/field", None, 5]


@pytest.mark.parametrize("text", DOTENV, ids=range(len(DOTENV)))
def test_dotenv_parity(text):
    assert run(port_tpl.parse_dotenv, text) == \
        run(ref_tpl.parse_dotenv, text)


@pytest.mark.parametrize("variables,template,strict", RENDER,
                         ids=range(len(RENDER)))
def test_render_parity(variables, template, strict, monkeypatch):
    monkeypatch.setenv("FLEET_TPL_TEST_VAR", "hello")
    out = []
    for mod in (ref_tpl, port_tpl):
        tp = mod.TemplateProcessor(strict=strict)
        tp.add_variables({"X": "low"})
        tp.add_variables(variables)
        out.append(run(tp.render_str, template, source="t.kdl"))
    assert out[1] == out[0]
    if out[0][0] == "error":
        assert out[1][1] == "FlowError"


def test_env_allowlist_parity():
    env = {"FLEET_STAGE": "live", "CI_JOB": "42", "APP_KEY": "k",
           "SECRET_TOKEN": "no", "PATH": "/bin"}
    got = []
    for mod in (ref_tpl, port_tpl):
        tp = mod.TemplateProcessor()
        tp.add_allowlisted_env(env)
        got.append(tp.variables)
    assert got[1] == got[0] == {"FLEET_STAGE": "live", "CI_JOB": "42",
                                "APP_KEY": "k"}


@pytest.mark.parametrize("text,stage", PREPASS, ids=range(len(PREPASS)))
def test_variables_prepass_parity(text, stage):
    assert run(port_tpl.extract_variables_with_stage, text, stage) == \
        run(ref_tpl.extract_variables_with_stage, text, stage)


def test_render_files_parity(tmp_path):
    (tmp_path / "a.kdl").write_text('service "{{ NAME }}" { }\n')
    (tmp_path / "b.kdl").write_text('stage "{{ STAGE }}" { }\n')
    paths = [str(tmp_path / "a.kdl"), str(tmp_path / "b.kdl")]
    got = []
    for mod in (ref_tpl, port_tpl):
        tp = mod.TemplateProcessor()
        tp.add_variables({"NAME": "web", "STAGE": "live"})
        got.append((tp.render_file(paths[0]), tp.render_files(paths)))
    assert got[1] == got[0]


@pytest.mark.parametrize("value", OP_REFS, ids=range(len(OP_REFS)))
def test_op_reference_detection_parity(value):
    assert port_secrets.is_op_reference(value) == \
        ref_secrets.is_op_reference(value)


@pytest.fixture
def fake_op(tmp_path, monkeypatch):
    """An `op` CLI on PATH: `op read <ref>` prints resolved:<ref>, and a
    reference whose field is `fail` exits 1 with a message."""
    script = tmp_path / "bin" / "op"
    script.parent.mkdir()
    script.write_text('#!/bin/sh\ncase "$2" in\n  */fail) echo "denied" >&2;'
                      ' exit 1;;\nesac\necho "resolved:$2"\n')
    script.chmod(script.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("PATH", f"{script.parent}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")
    return script


@pytest.mark.parametrize("ref", ["op://v/i/f", "op://v/i/fail", "plain"])
def test_resolve_reference_parity(fake_op, ref):
    assert run(port_secrets.resolve_reference, ref) == \
        run(ref_secrets.resolve_reference, ref)


def test_secret_variables_resolve_in_both(fake_op):
    variables = {"A": "op://v/i/f", "B": "plain", "C": "op://x/y/z"}
    assert port_secrets.resolve_op_references(variables) == \
        ref_secrets.resolve_op_references(variables) == \
        {"A": "resolved:op://v/i/f", "B": "plain",
         "C": "resolved:op://x/y/z"}
    got = []
    for mod in (ref_tpl, port_tpl):
        tp = mod.TemplateProcessor()
        tp.add_variables({"PASS": "op://v/i/f"})
        got.append(tp.render_str("{{ PASS }}"))
    assert got[1] == got[0] == "resolved:op://v/i/f"


def test_missing_op_binary_raises(monkeypatch):
    monkeypatch.setattr(port_secrets, "_op_binary", lambda: None)
    monkeypatch.setattr(ref_secrets, "_op_binary", lambda: None)
    got = run(port_secrets.resolve_reference, "op://v/i/f")
    assert got == run(ref_secrets.resolve_reference, "op://v/i/f")
    with pytest.raises(FlowError, match="op"):
        port_secrets.resolve_reference("op://v/i/f")
