"""The port's config reader (``isegprobe_torch/utils/config.py``, no YAML
package) and the two CLIs' settings against the JAX package's
``isegprobe_tpu/utils/config.py`` (PyYAML) and the root CLIs.

- ``load_yaml`` on the three committed files equals the JAX one;
- ``_parse_value`` and ``apply_overrides`` equal the JAX ones on a
  hypothesis corpus of scalars and flow lists (YAML 1.1 booleans in every
  spelling, octal, hex, binary, ``_``, base 60, exponent forms, nulls,
  quoted forms, nested lists);
- a form outside the reader's subset raises ``ValueError`` naming its line;
- ``python -m isegprobe_torch.evaluate checkpoint=x`` and ``python -m
  isegprobe_torch.train model=...`` take every key of
  ``configs/eval_cfg.yaml`` / ``configs/train_cfg.yaml`` (and the machine
  paths of ``main_cfg.yaml``) as the root's ``load_config`` gives it, and
  an edited file in another working directory reaches both packages alike.
"""

from __future__ import annotations

import math
import shutil
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from isegprobe_torch.utils import config as tc
from isegprobe_torch.utils.main_cfg import flatten
from isegprobe_tpu.utils import config as jc

REPO = Path(__file__).resolve().parents[1]
FILES = ("eval_cfg.yaml", "train_cfg.yaml", "main_cfg.yaml")


def same(a, b) -> bool:
    """Equal values of equal types (NaN equal to NaN), recursively."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("name", FILES)
def test_load_yaml_equals_pyyaml_on_the_files(name):
    path = REPO / "configs" / name
    got, want = tc.load_yaml(path), jc.load_yaml(path)
    assert isinstance(got, tc.EDict) and same(dict(got), dict(want))
    assert same(flatten(got), flatten(want))


# -- the scalar corpus ---------------------------------------------------------

_BOOLS = [c for w in ("yes", "no", "true", "false", "on", "off")
          for c in (w, w.capitalize(), w.upper(), w[0] + w[1:].upper())]
_NULLS = ["null", "Null", "NULL", "nULL", "~", ""]
_SPECIAL = [".inf", "-.inf", "+.Inf", ".INF", ".nan", ".NaN", "-.nan",
            "1:30", "-1:30:15", "1:30.5", "0", "-0", "+0", "00", "0_7",
            "012", "09", "0b101", "-0b1_1", "0x1F", "0xff_ff", "1.", ".5",
            "+.5", "-1.5e+3", "1.5e3", "2e-4", "-2E+04", "1e5", "3.0e-5",
            "1_000.5", "1__0", "_1", "e5", "1e", "inf", "nan", "yes!",
            "a b", "a #c", "a#c", "  padded  ", "/path/to/x.ckpt",
            "./configs/main_cfg.yaml", "fixed448,336", "GrabCut,Berkeley",
            "models/sbd/dinov2/patch-embed_noup.py", "@x", "`x", "*alias",
            ",a", "]", "}", "'a' b", "'a'#c", "'unclosed", '"\\q"',
            "[1", "[1, , 2]", "[1, 2,]", "[ ]", "[]", "[a b]", "[a:b]",
            "'#'", "[']']", "!local", "=", "<<", "--x", "?x", ":x"]


def _int_text(n: int, form: str) -> str:
    sign = "-" if n < 0 else ""
    n = abs(n)
    if form == "hex":
        return f"{sign}0x{n:x}"
    if form == "oct":
        return f"{sign}0{n:o}"
    if form == "bin":
        return f"{sign}0b{n:b}"
    if form == "under" and n >= 10:
        s = str(n)
        return f"{sign}{s[0]}_{s[1:]}"
    return f"{sign}{n}"


ints = st.builds(_int_text, st.integers(-10**6, 10**6),
                 st.sampled_from(["dec", "hex", "oct", "bin", "under"]))
floats = st.one_of(
    st.floats(-1e6, 1e6, allow_nan=False).map(lambda f: f"{f:.4f}"),
    st.floats(-1e6, 1e6, allow_nan=False).map(repr),
    st.floats(1e-9, 1e9).map(lambda f: f"{f:e}"),
    st.builds(lambda m, e, s: f"{m}e{s}{e}", st.integers(1, 99),
              st.integers(0, 12), st.sampled_from(["", "-", "+"])))
words = st.from_regex(r"[A-Za-z_/.][A-Za-z0-9_./,=+-]{0,12}", fullmatch=True)
_QUOTE_ALPHABET = st.characters(min_codepoint=32, max_codepoint=126,
                                blacklist_characters="\\")
single = st.text(_QUOTE_ALPHABET, max_size=10).map(
    lambda s: "'" + s.replace("'", "''") + "'")
double = st.lists(st.one_of(
    st.text(st.characters(min_codepoint=32, max_codepoint=126,
                          blacklist_characters='\\"'), max_size=4),
    st.sampled_from(["\\n", "\\t", "\\\\", '\\"', "\\x41", "\\u00e9",
                     "\\/", "\\ "])), max_size=4).map(
    lambda parts: '"' + "".join(parts) + '"')
scalars = st.one_of(st.sampled_from(_BOOLS + _NULLS + _SPECIAL), ints,
                    floats, words, single, double)
flow = st.recursive(
    st.one_of(ints, floats, words, single, double,
              st.sampled_from(_BOOLS + ["null", "~"])),
    lambda inner: st.lists(inner, max_size=4).map(
        lambda xs: "[" + ", ".join(x if isinstance(x, str) else str(x)
                                   for x in xs) + "]"),
    max_leaves=8)


def _outcome(fn, text):
    try:
        return ("value", fn(text))
    except ValueError as e:
        return ("raises", type(e).__name__)


@settings(max_examples=400, deadline=None)
@given(st.one_of(scalars, flow))
def test_parse_value_equals_jax(text):
    """Every corpus string: the JAX value, or JAX's raw text where PyYAML
    refuses it."""
    want = _outcome(jc._parse_value, text)
    got = _outcome(tc._parse_value, text)
    assert want[0] == got[0] and (want[0] == "raises" or same(got[1],
                                                              want[1])), (
        text, want, got)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.tuples(
    st.lists(st.sampled_from(["a", "b", "training", "lr", "x_1"]),
             min_size=1, max_size=3),
    st.one_of(scalars, flow)), max_size=5))
def test_apply_overrides_equals_jax(overrides):
    args = [".".join(k) + "=" + v for k, v in overrides]
    base = {"a": {"b": 1}, "lr": 0.5, "training": {"seed": 0}}
    want = jc.apply_overrides(jc.EDict.convert(base), args)
    got = tc.apply_overrides(tc.EDict.convert(base), args)
    assert same(dict(got), dict(want))
    assert isinstance(got, tc.EDict)


@pytest.mark.parametrize("text", [
    "&a b", "{a: 1}", "- 1", "a: b", "|", ">", "!!str x", "2026-10-18",
    "a\tb", "[1, {a: 2}]", "[a: 1]", "!!int 3"])
def test_parse_value_refuses_other_forms(text):
    """A form PyYAML reads and the reader does not raises; it is never
    taken for another value."""
    with pytest.raises(ValueError):
        tc._parse_value(text)


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\n", 1), ("a: 1\nb: *x\n", 2), ("a: !!str 1\n", 1),
    ("a: |\n  text\n", 1), ("a: >\n  t\n", 1), ("- 1\n", 1),
    ("a:\n  - 1\n", 2), ("a: {b: 1}\n", 1), ("a: 2026-10-18\n", 1),
    ("\ta: 1\n", 1), ("a: 'x\n  y'\n", 1), ("a: [1,\n  2]\n", 1),
    ("a: 1\n  b: 2\n", 2), ("? a\n", 1), ("---\na: 1\n", 1),
    ("a: b: c\n", 1), ("a: 1\nb:\n    c: 1\n   d: 2\n", 4),
    ("yes: 1\n", 1), ("'a': 1\n", 1), ("a: b\n just text\n", 2)])
def test_load_yaml_refuses_other_forms(tmp_path, text, line):
    path = tmp_path / "x.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"x.yaml:{line}:"):
        tc.load_yaml(path)


def test_load_yaml_reads_the_files_forms(tmp_path):
    """Comments, nesting, a key with nothing under it, quoted values,
    nested flow lists, ``hydra`` dropped: as PyYAML."""
    text = ("# top\n"
        "a: 1  # one\n"
        "b:\n"
        "  c: 'x # not a comment'\n"
        "  d: \"tab\\there\"\n"
        "  e:\n"
        "    f: [[0, 3], [15, 1]]\n"
        "    g: [yes, No, ~, 0x10, 1.5, 2e-4, 'q', \"r\"]\n"
        "  h:\n"
        "i: ''\n"
        "j:   # nothing\n"
        "hydra:\n"
        "  run: x\n"
        "k: 0o7\n")
    path = tmp_path / "x.yaml"
    path.write_text(text)
    assert same(dict(tc.load_yaml(path)), dict(jc.load_yaml(path)))


# -- the CLIs against the root's settings -------------------------------------

def _root_eval(argv):
    cfg = jc.load_config("configs/eval_cfg.yaml", argv)
    main = jc.load_yaml(cfg.main_cfg_path)
    return cfg, main


def _check_eval(port, root, main):
    """Every key of the file as the root's main() uses it."""
    for key, want in root.items():
        if key == "mxu_pad":  # the port picks LoftUp's layout by dtype
            assert key not in port
            continue
        if key == "target_iou":
            want = (1.01 if (root.iou_analysis or root.print_ious)
                    and root.min_n_clicks <= 1 else max(0.8, want))
        if key == "logs_path":
            want = str(Path(want or Path(main.EXPS_PATH)
                            / "evaluation_logs"))
        assert same(port[key], want), (key, port[key], want)
    assert port["EXPS_PATH"] == main.EXPS_PATH
    for key, path in main.DATASETS.items():
        if f"DATASETS.{key}" in port:
            assert port[f"DATASETS.{key}"] == path


@pytest.mark.parametrize("extra", [
    [], ["datasets=GrabCut", "n_clicks=5", "target_iou=0.85",
         "print_ious=false", "device_loop=yes", "device_batch=0x8",
         "dtype=bfloat16", "thresh=4.9e-1", "model_name=m",
         "clicks_limit=3", "cpu=On", "group_max_jobs=012"]])
def test_evaluate_cli_takes_the_roots_settings(monkeypatch, extra):
    """``parse_args(["checkpoint=x", ...])`` against the root's
    ``load_config("configs/eval_cfg.yaml", ...)`` on every key: with
    ``checkpoint=`` alone the port evaluates ``GrabCut,Berkeley,SBD,DAVIS``
    at ``fixed224``, as the root does."""
    from isegprobe_torch.evaluate import parse_args

    monkeypatch.chdir(REPO)
    argv = ["checkpoint=x", *extra]
    port = parse_args(argv)
    root, main = _root_eval(argv)
    _check_eval(port, root, main)
    if not extra:
        assert port["dataset_names"] == ["GrabCut", "Berkeley", "SBD",
                                         "DAVIS"]
        assert port["zoomin"]["target_size"] == (224, 224)


def _root_train(argv):
    return flatten(jc.load_config("configs/train_cfg.yaml", argv))


@pytest.mark.parametrize("extra", [
    [], ["training_params.epochs=3", "training_params.crop_size=[448, 448]",
         "training_params.lr_milestones=[5,8]", "training.resume_exp=000",
         "dataloader.mp=yes", "training.seed=-1", "exp.name=run_1",
         "training_params.dtype=bfloat16"]])
def test_train_cli_takes_the_roots_settings(monkeypatch, extra):
    """``parse_args(["model=synthetic_dinov2_noup", ...])`` (and the
    root's ``exp.model_path=models/...``) against the root's
    ``load_config("configs/train_cfg.yaml", ...)`` on every key, and
    ``main_cfg.yaml``'s machine paths."""
    from isegprobe_torch.train import parse_args

    monkeypatch.chdir(REPO)
    script = "exp.model_path=models/synthetic/dinov2_noup.py"
    want = _root_train([script, *extra])
    for argv in (["model=synthetic_dinov2_noup", *extra], [script, *extra]):
        port = parse_args(argv)
        assert port["model"] == "synthetic_dinov2_noup"
        for key, value in want.items():
            assert same(port[key], value), (key, port[key], value)
    main = flatten(jc.load_yaml("configs/main_cfg.yaml"))
    for key in ("DATASETS.SBD_PATH", "PRETRAINED_MODELS.DINOV2_VITS14"):
        assert port[key] == main[key]


def test_an_edited_config_reaches_both_packages(tmp_path, monkeypatch):
    """Edited copies of the three files in another working directory reach
    the port's CLIs as they reach the root's ``load_config``; a key on the
    command line still wins over ``main_cfg.yaml``."""
    from isegprobe_torch import evaluate, train

    (tmp_path / "configs").mkdir()
    for name in FILES:
        shutil.copy(REPO / "configs" / name, tmp_path / "configs" / name)
    ev = tmp_path / "configs" / "eval_cfg.yaml"
    ev.write_text(ev.read_text().replace(
        "datasets: 'GrabCut,Berkeley,SBD,DAVIS'", "datasets: 'DAVIS'")
        .replace("eval_mode: 'fixed224'", "eval_mode: 'fixed336'")
        .replace("n_clicks: 20", "n_clicks: 7"))
    tr = tmp_path / "configs" / "train_cfg.yaml"
    tr.write_text(tr.read_text().replace("epochs: 20", "epochs: 3")
                  .replace("crop_size: [224, 224]", "crop_size: [112, 112]"))
    mc = tmp_path / "configs" / "main_cfg.yaml"
    mc.write_text(mc.read_text().replace('"/data/davis"', '"/mine/davis"')
                  .replace('"/data/sbd"', '"/mine/sbd"'))
    monkeypatch.chdir(tmp_path)
    port = evaluate.parse_args(["checkpoint=x"])
    root, main = _root_eval(["checkpoint=x"])
    _check_eval(port, root, main)
    assert port["dataset_names"] == ["DAVIS"] and port["n_clicks"] == 7
    assert port["zoomin"]["target_size"] == (336, 336)
    assert port["DATASETS.DAVIS_PATH"] == "/mine/davis"
    assert evaluate.parse_args(["checkpoint=x", "DATASETS.DAVIS_PATH=/d"])[
        "DATASETS.DAVIS_PATH"] == "/d"
    tport = train.parse_args(["model=sbd_dinov2_noup"])
    want = _root_train(["exp.model_path=models/sbd/dinov2/patch-embed_noup.py"])
    for key, value in want.items():
        assert same(tport[key], value), key
    assert tport["training_params.epochs"] == 3
    assert tport["DATASETS.SBD_PATH"] == "/mine/sbd"
    with pytest.raises(ValueError, match="unknown key"):
        evaluate.parse_args(["checkpoint=x", "colour=red"])
    with pytest.raises(ValueError, match="unknown key"):
        train.parse_args(["model=sbd_dinov2_noup", "training.colour=red"])
