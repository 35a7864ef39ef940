"""Run configuration: a flat YAML file -> ``argparse.Namespace``.

Port of ``hypad_tpu.utils.config``: the same ``DEFAULTS``, validation
messages and run directory. The file is read by :func:`parse_flat_yaml`, a
reader of the flat subset of YAML that the configs use (``key: scalar``
lines, block lists of scalars, comments), which gives what PyYAML's
``yaml.safe_load`` gives on that subset, YAML 1.1 scalar rules included:
``5e-4`` is the string ``'5e-4'`` (a float needs a dot), ``1.0e-3`` is a
float, ``010`` is the octal 8, ``yes``/``off`` are booleans. Anything else
(nested maps, flow collections, anchors, tags, block scalars, dates,
sexagesimal numbers, escapes in double quotes) raises ``ValueError``: the
reader never guesses.
"""

from __future__ import annotations

import argparse
import math
import os
import re

DEFAULTS = {
    "dataset": "MSL",
    "signal": "C-2",
    "epochs": 40,
    "hyperbolic": True,
    "signal_shape": 100,
    "lr": 0.0005,
    "batch_size": 64,
    "save_result": False,
    "filename": "",
    "rec_error": "dtw",
    "combination": "mult",
    "interval": 21600,
    "unique_dataset": False,
    "resume": False,
    "resume_epoch": 10,
    "load": False,
    "new_features": False,
    "id": 1,
    "split": 1,
    "data_root": "./data",
    "output_root": ".",
    "seed": 0,
    "devices": "all",
    # persist the inference tensors (inference.npz); needed by load: true
    "save_artifacts": True,
    # "float16" halves the persisted (N, W) tensors; scores of the run that
    # writes them are computed in f32 either way
    "artifact_dtype": "float32",
    # the critic step: False autograd, True the generator forwards in torch
    # then K4, "full" K5 (train/trainer.py)
    "fused_critics": False,
    # "minimal" drops eucl_recons and gt_signal from a hyperbolic run's
    # artifacts (no hyperbolic scoring reads them)
    "artifact_set": "full",
    # None: no plot for a univariate run; True is not ported (ROADMAP A12)
    "save_plots": None,
}

VALID_COMBINATIONS = ("sum", "mult", "uncertainty", "critic",
                      "critic_uncertainty", "sum_uncertainty", "rec",
                      "rec_uncertainty")
VALID_REC_ERRORS = ("point", "area", "dtw")
EUCLIDEAN_COMBINATIONS = ("mult", "sum", "rec", "critic")


# ---------------------------------------------------------------------------
# the flat-YAML reader
# ---------------------------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers (yaml/resolver.py), minus the forms
# this reader refuses
_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                           "Off", "OFF"), False)}
_NULLS = ("~", "null", "Null", "NULL", "")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                      |[-+]?0[0-7_]+
                      |[-+]?(?:0|[1-9][0-9_]*)
                      |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
# sexagesimal numbers and dates resolve to types this reader refuses
_REFUSED = re.compile(r"^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)$")
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")
_NOT_PLAIN_START = set("[]{},#&*!|>%@`")


def _int(text):
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * int(value)


def _float(text):
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    value = value.lstrip("+-")
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    return sign * float(value)


def _resolve(text, where):
    """A plain scalar's value under PyYAML's YAML 1.1 rules."""
    if _REFUSED.match(text):
        raise ValueError(f"{where}: {text!r} is not a scalar this reader "
                         "takes (sexagesimal, date, merge or value key)")
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _FLOAT.match(text):
        return _float(text)
    if _INT.match(text):
        return _int(text)
    return text


def _end_of_scalar(rest, where):
    """After a quoted scalar only blanks and a comment may follow."""
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"{where}: unexpected text {rest!r} after a quoted "
                         "scalar")


def _scalar(text, where):
    """The value of the scalar ``text`` (left-stripped, may end in a
    comment)."""
    if text.startswith("'"):
        out, i = [], 1
        while True:
            j = text.find("'", i)
            if j < 0:
                raise ValueError(f"{where}: unterminated quoted scalar")
            out.append(text[i:j])
            if text.startswith("''", j):
                out.append("'")
                i = j + 2
                continue
            _end_of_scalar(text[j + 1:], where)
            return "".join(out)
    if text.startswith('"'):
        j = text.find('"', 1)
        if j < 0:
            raise ValueError(f"{where}: unterminated quoted scalar")
        if "\\" in text[1:j]:
            raise ValueError(f"{where}: escapes in double-quoted scalars are "
                             "not read")
        _end_of_scalar(text[j + 1:], where)
        return text[1:j]
    comment = re.search(r"[ \t]#", text)
    plain = (text[:comment.start()] if comment else text).rstrip()
    if plain.startswith("#"):
        plain = ""
    if plain and (plain[0] in _NOT_PLAIN_START
                  or plain[0] in "-?:" and (len(plain) == 1
                                            or plain[1] in " \t")):
        raise ValueError(f"{where}: {plain!r} is not a flat scalar (flow "
                         "collections, anchors, tags, block scalars and "
                         "nested entries are not read)")
    if ": " in plain or "\t" in plain or plain.endswith(":"):
        raise ValueError(f"{where}: {plain!r} holds a mapping value")
    return _resolve(plain, where)


def parse_flat_yaml(text):
    """The dict that ``yaml.safe_load`` gives for the flat YAML ``text``
    (None for an empty document). Top-level ``key: scalar`` lines and block
    lists of scalars under a ``key:`` line are read; anything else raises
    ``ValueError``."""
    result = {}
    list_key = None      # the key whose value is an open block list
    list_indent = None   # the indentation of that list's items
    for lineno, line in enumerate(text.splitlines(), 1):
        where = f"line {lineno}"
        body = line.lstrip(" ")
        indent = len(line) - len(body)
        if body.startswith("\t"):
            raise ValueError(f"{where}: tab indentation")
        stripped = body.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if indent == 0 and (line.startswith(("---", "...", "%"))):
            raise ValueError(f"{where}: document markers and directives are "
                             "not read")
        if stripped == "-" or stripped.startswith(("- ", "-\t")):
            if list_key is None or (list_indent is not None
                                    and indent != list_indent):
                raise ValueError(f"{where}: a list item outside a key's "
                                 "block list")
            list_indent = indent
            item = stripped[1:].lstrip()
            if result[list_key] is None:
                result[list_key] = []
            result[list_key].append(_scalar(item, where))
            continue
        if indent:
            raise ValueError(f"{where}: nested mappings and multi-line "
                             "scalars are not read")
        match = re.match(r"^([^:#'\"]*?):(?:[ \t]|$)", line)
        if match is None:
            raise ValueError(f"{where}: not a 'key: value' line")
        key = match.group(1)
        if not _KEY.match(key) or not isinstance(_resolve(key, where), str):
            raise ValueError(f"{where}: key {key!r} is not a plain name")
        rest = line[match.end():].lstrip()
        list_key, list_indent = None, None
        if not rest or rest.startswith("#"):
            result[key] = None
            list_key = key
        else:
            result[key] = _scalar(rest, where)
    return result or None


def _dump_scalar(value):
    """``value`` as a flat-YAML scalar that this reader and PyYAML both
    read back as ``value``: strings single-quoted, floats with a dot."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        mantissa, _, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        return mantissa + (f"e{exponent}" if exponent else "")
    if isinstance(value, str):
        return "'" + value.replace("'", "''") + "'"
    raise ValueError(f"{value!r} is not a flat scalar")


def dump_flat_yaml(mapping):
    """The flat YAML text of ``mapping`` (scalars and lists of scalars),
    keys sorted as ``yaml.safe_dump`` sorts them; :func:`parse_flat_yaml`
    reads it back to ``mapping``, but for an empty list, which it writes
    as an empty value (read back as None)."""
    lines = []
    for key in sorted(mapping):
        value = mapping[key]
        if isinstance(value, (list, tuple)):
            lines.append(f"{key}:")
            lines.extend(f"- {_dump_scalar(v)}" for v in value)
        else:
            lines.append(f"{key}: {_dump_scalar(value)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

def load_config(path_or_dict) -> argparse.Namespace:
    """``DEFAULTS`` updated with a YAML file's keys (or a dict's), plus the
    fixed ``latent_space_dim`` of 20, validated."""
    if isinstance(path_or_dict, dict):
        raw = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = parse_flat_yaml(f.read())
    cfg = dict(DEFAULTS)
    cfg.update(raw or {})
    cfg["latent_space_dim"] = 20
    ns = argparse.Namespace(**cfg)
    validate(ns)
    return ns


def validate(params):
    if getattr(params, "artifact_dtype", "float32") not in ("float32",
                                                            "float16"):
        raise ValueError("artifact_dtype must be 'float32' or 'float16', "
                         f"got {params.artifact_dtype!r}")
    if getattr(params, "fused_critics", False) not in (False, True, "full"):
        raise ValueError("fused_critics must be false, true, or 'full', "
                         f"got {params.fused_critics!r}")
    if getattr(params, "artifact_set", "full") not in ("full", "minimal"):
        raise ValueError("artifact_set must be 'full' or 'minimal', "
                         f"got {params.artifact_set!r}")
    if params.combination not in VALID_COMBINATIONS:
        raise ValueError(
            f"combination {params.combination!r} not in {VALID_COMBINATIONS}")
    if (not params.hyperbolic
            and params.signal != "multivariate"
            and params.combination not in EUCLIDEAN_COMBINATIONS):
        raise ValueError(
            f"combination {params.combination!r} requires hyperbolic: true "
            f"(euclidean supports {EUCLIDEAN_COMBINATIONS})")
    if params.rec_error not in VALID_REC_ERRORS:
        raise ValueError(
            f"rec_error {params.rec_error!r} not in {VALID_REC_ERRORS}")
    if params.batch_size <= 0 or params.epochs < 0:
        raise ValueError("batch_size must be positive and epochs >= 0")


def run_dir(params) -> str:
    """trained_models/models_{hyper|eucl}_{dataset}_{epochs}_{lr}/{dataset}
    [/{signal} unless multivariate], under ``output_root``."""
    geo = "hyper" if params.hyperbolic else "eucl"
    base = os.path.join(
        params.output_root, "trained_models",
        f"models_{geo}_{params.dataset}_{params.epochs}_{params.lr}",
        str(params.dataset),
    )
    if params.signal != "multivariate":
        base = os.path.join(base, str(params.signal))
    return base
