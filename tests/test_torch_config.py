"""The port's configs and YAML reader against the JAX package's (CPU).

``melogan_torch.utils.yaml_subset.safe_load`` is held against PyYAML's
``yaml.safe_load`` (which the JAX package reads its configs with) on every
scalar spelling of the subset below and on every ``configs/*.yaml``, and
must raise on the spellings outside it; each typed config's ``from_yaml``
is held against JAX's field for field, types included, on every config
file (each class on each file, so the fallbacks are exercised too) and on
an empty file. Exact equality: nothing here is numeric work.
"""
import dataclasses
import glob
import math
import os

import pytest
import yaml

from melogan_tpu import config as jconfig

from melogan_torch import config as tconfig
from melogan_torch.utils.yaml_subset import safe_load

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))

SCALARS = [
    # floats need a dot; an exponent without one leaves a string (YAML 1.1)
    "2e-4", "1e5", "1.0e-5", "1.0E+3", "0.0001", "3.14159", "-0.5", "+1.5", "1.", "0.",
    # decimal ints
    "0", "-0", "+7", "-17",
    # booleans and nulls
    "true", "false", "~", "null", "",
    # strings, plain and quoted ("y" and "n" are strings to PyYAML)
    "abc", "y", "n", "warm_start", "experiments/gan/checkpoints", "ed_best.pth", "'quoted'",
    '"double"', "'2e-4'", '"true"', "'# not a comment'", "''",
    # flow lists
    "[256, 128]", "[happy, sad, angry, calm]", "[0.5, 0.999]", "[]", "[1, 2.5, x, null, true]",
]

# YAML 1.1 spellings outside the subset: the reader raises rather than
# risk reading them differently from PyYAML
UNSUPPORTED_SCALARS = [
    "1.0e5", ".5", "1_0.5", "1:30.5", ".inf", "-.inf", ".nan", "1e-4x",
    "1_000", "010", "08", "0x1F", "0b101", "0o10", "1:30",
    "True", "TRUE", "tRUE", "yes", "No", "ON", "off", "Null", "NULL",
    "a#b", "http://x", "a b", "'it''s'", '"tab\\t"', "[a, ]", "['a, b', c]",
]


def _same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_spellings_resolve_as_pyyaml(text):
    want = yaml.safe_load(f"k: {text}  # comment\n")["k"]
    got = safe_load(f"k: {text}  # comment\n")["k"]
    assert _same(got, want), (got, want)


@pytest.mark.parametrize("text", UNSUPPORTED_SCALARS)
def test_spellings_outside_the_subset_raise(text):
    with pytest.raises(ValueError):
        safe_load(f"k: {text}\n")


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_read_as_pyyaml(path):
    text = open(path).read()
    assert safe_load(text) == yaml.safe_load(text)
    assert tconfig.load_yaml(path) == jconfig.load_yaml(path)


def test_nested_maps_and_keys_as_pyyaml():
    text = ("A:\n  b: 1\n  c: [x]\n  d:\n    e: 2.5\nf:\n_k2: \"v\"\n"
            "g: x  # c\n# whole-line comment\n\nh: ''\n")
    assert safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", [
    "- a\n",  # block list
    "a: {b: 1}\n",  # flow map
    "a: |\n  x\n",  # block scalar
    "a: &x 1\n",  # anchor
    "a: *x\n",  # alias
    "a: !!str 1\n",  # tag
    "a: 2001-12-14\n",  # timestamp
    "---\na: 1\n",  # document marker
    "a: [[1]]\n",  # nested flow list
    "a: [1, 2\n",  # unclosed flow list
    "a: 1\n  b: 2\n",  # multi-line scalar
    "a:\n\tb: 1\n",  # tab indentation
    "a: b: c\n",  # a mapping value in a plain scalar
    "a: 'open\n",  # unterminated quote
    "a: [1, , 2]\n",  # empty flow entry
    "plain scalar\n",  # not a mapping
    "'q k': v\n",  # quoted key
    "1: one\n",  # key that is not an identifier
], ids=lambda t: t.split("\n")[0] or "blank")
def test_what_the_subset_does_not_cover_raises(text):
    with pytest.raises(ValueError):
        safe_load(text)


@pytest.mark.parametrize("cls", ["AEConfig", "EDConfig", "GANConfig"])
@pytest.mark.parametrize("path", CONFIGS + ["empty"], ids=os.path.basename)
def test_from_yaml_equals_jax_field_for_field(cls, path, tmp_path):
    if path == "empty":
        path = str(tmp_path / "empty.yaml")
        open(path, "w").close()
    ours = dataclasses.asdict(getattr(tconfig, cls).from_yaml(path))
    theirs = dataclasses.asdict(getattr(jconfig, cls).from_yaml(path))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert _same(ours[k], theirs[k]) or (ours[k] == theirs[k] and type(ours[k]) is type(theirs[k])), k


@pytest.mark.parametrize("cls", ["AugmentConfig", "AEConfig", "OptimizerConfig", "SchedulerConfig",
                                 "EDConfig", "GANConfig"])
def test_dataclass_defaults_equal_jax(cls):
    assert tconfig.asdict(getattr(tconfig, cls)()) == jconfig.asdict(getattr(jconfig, cls)())


def test_yaml_fallbacks_differ_from_dataclass_defaults_as_in_jax(tmp_path):
    """The fallbacks that are not the dataclass defaults
    (``melogan_tpu/config.py:226, 230, 385, 400``)."""
    path = str(tmp_path / "empty.yaml")
    open(path, "w").close()
    gan, ed = tconfig.GANConfig.from_yaml(path), tconfig.EDConfig.from_yaml(path)
    assert (gan.integration_mode, gan.lambda_emotion) == ("conditioning", 1.0)
    assert (ed.input_mode, ed.latent_dim) == ("latent", 128)
    ed_yaml = tconfig.EDConfig.from_yaml(os.path.join(REPO, "configs", "ed.yaml"))
    assert ed_yaml.optimizer.lr == 2e-4 and isinstance(ed_yaml.optimizer.lr, float)
    assert tconfig.load_yaml(os.path.join(REPO, "configs", "ed.yaml"))["optimizer"]["lr"] == "2e-4"


def test_config_dict_answers_both_spellings():
    for mod in (tconfig, jconfig):
        d = mod.ConfigDict({"LR": 1, "seed": 2})
        got = (d.get("lr"), d.get("SEED"), d.get("x", 3), d["lr"], "Seed" in d, "x" in d)
        assert got == (1, 2, 3, 1, True, False)
        with pytest.raises(KeyError):
            d["missing"]


def test_ema_decay_is_validated_as_in_jax():
    for bad in (1.0, -0.1):
        for mod in (tconfig, jconfig):
            with pytest.raises(ValueError, match=r"\[0, 1\)"):
                mod.GANConfig(ema_decay=bad)
