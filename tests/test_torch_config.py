"""The port's YAML reader (vatl4pose_tpu_torch/config.py, no PyYAML)
against PyYAML's safe_load, which is what the JAX package's configs give:
every configs/**/*.yaml, the plain scalars' YAML 1.1 resolution, a
hypothesis round trip through yaml.safe_dump, and a ValueError naming the
line for each construct the reader refuses."""

import math
from pathlib import Path

import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from vatl4pose_tpu import config as jax_config
from vatl4pose_tpu_torch import config

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(str(p.relative_to(REPO))
                 for p in (REPO / "configs").rglob("*.yaml"))


def test_configs_are_found():
    assert len(CONFIGS) >= 11


@pytest.mark.parametrize("path", CONFIGS)
def test_every_config_reads_as_safe_load(path):
    """update_config gives the tree yaml.safe_load gives (and the JAX
    package's update_config), types included."""
    cfg = config.update_config(str(REPO / path))
    with open(REPO / path) as f:
        want = yaml.safe_load(f)
    assert isinstance(cfg, config.Cfg)
    assert cfg == want == jax_config.update_config(str(REPO / path))
    assert repr(dict(cfg)) == repr(want)          # 1 vs 1.0 vs True
    assert config.load_config_str((REPO / path).read_text()) == want


SCALARS = [
    "1e-3", "0.00008", "1.0e+3", "1.0e3", "6.5e-05", ".5", "-.5", "+1.5",
    ".inf", "-.Inf", "+.INF", "3.", "1_000.5", "190:20:30.15", "0", "-0",
    "+12", "017", "0o17", "0x1F", "-0x1f", "0b101", "1_000", "1:30",
    "-1:30", "09", "true", "True", "TRUE", "false", "yes", "No", "on",
    "OFF", "y", "n", "~", "null", "Null", "NULL", "", "''", '""', "'yes'",
    '"1"', "'it''s'", '"a\\tb\\u00e9\\x41\\"\\\\"', "abc", "a b",
    "a#b", "a # comment", "http://x.y/z:8080", "a:b", "-a", "?a", ":a",
    "'*'", "data/PoseTrack21/", "./data", "~/x", "[]", "[1, 'x, y', 2.5]",
    "[a, b, ]", "[ yes , ~ , 0x10 ]", "[\"a]\", 'b''c']", "<", "1.2.3",
    "0.1.2", "1e3"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_resolves_as_safe_load(text):
    doc = f"k: {text}\n"
    got = config.load_config_str(doc)["k"]
    want = yaml.safe_load(doc)["k"]
    assert repr(got) == repr(want)


def test_nan_and_structure():
    assert math.isnan(config.load_config_str("k: .NaN")["k"])
    text = """# comment
A:   # trailing comment
  B:
  - 1
  - - x
    - y
  - C: 2
    D:
      E: [3]
  F:
    - 4
  G:
'q k': v
1: one
"""
    assert config.parse_yaml(text) == yaml.safe_load(text)
    assert config.parse_yaml("") is None
    assert config.parse_yaml("---\na: 1\n") == {"a": 1}
    assert config.parse_yaml("- a\n- b\n") == ["a", "b"]
    assert config.parse_yaml("plain\n") == "plain"


KEYS = st.text(alphabet="abcXYZ_019 -.:#'\"/", min_size=1, max_size=8)
STRINGS = st.text(alphabet=st.characters(
    codec="utf-8", exclude_categories=("Cs", "Cc", "Zl", "Zp")),
    max_size=12) | st.sampled_from(
        ["yes", "no", "on", "off", "null", "~", "1e-3", "0x10", "017",
         "1:30", "-", "- a", "a: b", "#x", "x #y", "'", '"', "[1]", "{}",
         "&a", "*a", "!t", "|", ">", "%", "@", "`", "2001-12-14", "", " ",
         " lead", "trail ", "=", "<<", "?", ":"])
SCALAR_VALUES = (st.none() | st.booleans()
                 | st.integers(-2**63, 2**63)
                 | st.floats(allow_nan=False)
                 | STRINGS)
TREES = st.recursive(
    SCALAR_VALUES,
    lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(KEYS, kids, min_size=1, max_size=4),
    max_leaves=20)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.dictionaries(KEYS, TREES, min_size=1, max_size=5))
def test_round_trip_through_safe_dump(tree):
    """Nested dicts and lists of the supported scalars, dumped in block
    style by yaml.safe_dump on one line each, read back as yaml.safe_load
    reads them (timestamps and the merge key, which safe_dump may leave
    plain, are refused instead)."""
    text = yaml.safe_dump(tree, default_flow_style=False, width=10**6,
                          allow_unicode=False)
    want = yaml.safe_load(text)
    try:
        got = config.parse_yaml(text)
    except ValueError as e:
        assert "timestamp" in str(e) or "merge" in str(e), (text, e)
        return
    assert repr(got) == repr(want), text


@settings(max_examples=200, deadline=None, derandomize=True)
@given(st.lists(SCALAR_VALUES, max_size=6))
def test_flow_sequences_round_trip(items):
    """Flow sequences of scalars, as safe_dump writes them in flow
    style."""
    text = "k: " + yaml.safe_dump(items, default_flow_style=True,
                                  width=10**6, allow_unicode=False)
    want = yaml.safe_load(text)
    try:
        got = config.parse_yaml(text)
    except ValueError as e:
        assert "timestamp" in str(e) or "merge" in str(e), (text, e)
        return
    assert repr(got) == repr(want), text


REFUSED = [
    ("anchor", "a: 1\nb: &x 2\n", 2),
    ("alias", "a: 1\nb:\n  - *x\n", 3),
    ("tag", "a: !!str 1\n", 1),
    ("literal block scalar", "a: 1\nb: |\n  x\n", 2),
    ("folded block scalar", "a: >-\n  x\n", 1),
    ("flow mapping", "a:\n  b: {c: 1}\n", 2),
    ("empty flow mapping", "a: {}\n", 1),
    ("nested flow sequence", "a: [1, [2]]\n", 1),
    ("multi-line flow sequence", "a: [1,\n  2]\n", 1),
    ("second document", "a: 1\n---\nb: 2\n", 2),
    ("document end", "a: 1\n...\n", 2),
    ("directive", "%YAML 1.1\n---\na: 1\n", 1),
    ("tab indentation", "a:\n\tb: 1\n", 2),
    ("tab in a value", "a:\n  b: 1\tc\n", 2),
    ("multi-line plain scalar", "a: one\n  two\n", 2),
    ("multi-line quoted scalar", "a: 'one\n  two'\n", 1),
    ("complex key", "? a\n: b\n", 1),
    ("timestamp", "a:\n  b: 2001-12-14\n", 2),
    ("merge key", "a:\n  <<: 1\n", 2),
    ("bad escape", 'a: "\\q"\n', 1),
    ("text after a quoted scalar", "a: 'x' y\n", 1),
    ("mapping in a plain scalar", "a: b: c\n", 1),
    ("sequence where a value goes", "a: - b\n", 1),
    ("bad dedent", "a:\n    b: 1\n  c: 2\n", 3),
    ("sequence in a mapping", "a: 1\n- b\n", 2),
]


@pytest.mark.parametrize("name,text,line", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_refused_construct_names_its_line(tmp_path, name, text, line):
    path = tmp_path / "c.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=rf"^{path}:{line}: "):
        config.update_config(str(path))
    with pytest.raises(ValueError, match=rf"^<string>:{line}: "):
        config.load_config_str(text)
