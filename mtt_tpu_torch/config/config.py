"""Experiment configuration (port of mtt_tpu/config/config.py): the YAML
experiment files of ``configs/``, the task table with each task's output
channels and resize modes, the per-database scales and the derived output
paths.

The card's machine has no PyYAML, so ``load_yaml`` reads the subset of YAML
that the files in ``configs/`` use: comments, nested block mappings, plain
scalars resolved as PyYAML's ``safe_load`` resolves them (ints, floats such
as ``2.e-5``, ``True``/``False``, null, strings), quoted strings, and flow
lists and mappings such as ``[512, 1024]`` and ``{'max_norm': 10}``. It
raises on anything else (block sequences, anchors, tags, multi-line
scalars) rather than read it differently.

This module holds the port's one copy of the task table and of the
database scales; the model factory reads them from here.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Tuple


class Config(dict):
    """Attribute-access dict (nested)."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @classmethod
    def wrap(cls, obj: Any) -> Any:
        if isinstance(obj, dict):
            return cls({k: cls.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(cls.wrap(v) for v in obj)
        return obj


# per-task resize modes: ``interp`` for the labels during augmentation,
# ``infer_interp`` for predictions at eval time
TASK_META: Dict[str, Dict[str, Any]] = {
    "image": {"interp": "cubic"},
    "semseg": {"interp": "nearest", "infer_interp": "nearest"},
    "depth": {"interp": "nearest", "infer_interp": "linear"},
    "human_parts": {"interp": "nearest", "infer_interp": "nearest"},
    "sal": {"interp": "nearest", "infer_interp": "linear"},
    "normals": {"interp": "cubic", "infer_interp": "linear"},
    "edge": {"interp": "nearest", "infer_interp": "linear"},
    "3ddet": {},
}

_SEMSEG_CLASSES = {"PASCALContext": 21, "NYUD": 40, "Cityscapes3D": 19}
# output channels of each task, in the order the task table lists them
# (semseg: the database's class count; 3ddet: 12 regression + 6 classes)
_TASK_OUTPUTS = (("semseg", None), ("depth", 1), ("human_parts", 7),
                 ("sal", 2), ("normals", 3), ("edge", 1), ("3ddet", 12 + 6))

# train / test input scales per database, (height, width)
DB_SCALES = {
    "PASCALContext": ((512, 512), (512, 512)),
    "NYUD": ((448, 576), (448, 576)),
    "Cityscapes3D": ((1024, 2048), (1024, 2048)),
}


def task_table(db_name: str, task_dictionary: dict):
    """(task names, {task: output channels}) of a config's
    ``task_dictionary`` block, in the task table's order."""
    names, num_out = [], {}
    for name, n in _TASK_OUTPUTS:
        if task_dictionary.get(f"include_{name}", False):
            names.append(name)
            num_out[name] = _SEMSEG_CLASSES[db_name] if n is None else n
    return tuple(names), num_out


def parse_task_dictionary(db_name: str, task_dictionary: Dict[str, Any]
                          ) -> Tuple[Config, Dict[str, Any]]:
    """The task table of the YAML ``task_dictionary`` block: (TASKS with
    NAMES, NUM_OUTPUT, FLAGVALS, INFER_FLAGVALS, and the Cityscapes-3D depth
    range; the other keys it sets, ``edge_w`` and ``eval_edge``)."""
    if task_dictionary.get("include_semseg", False) and \
            db_name not in _SEMSEG_CLASSES:
        raise NotImplementedError(f"semseg not defined for db {db_name}")
    names, num_out = task_table(db_name, task_dictionary)
    allowed = {"human_parts": ("PASCALContext",),
               "sal": ("PASCALContext",),
               "normals": ("PASCALContext", "NYUD"),
               "edge": ("PASCALContext", "NYUD")}
    for name in names:
        assert db_name in allowed.get(name, (db_name,)), (name, db_name)
    if "3ddet" in names and db_name != "Cityscapes3D":
        raise NotImplementedError("3ddet requires Cityscapes3D")
    tasks = Config(NAMES=list(names), NUM_OUTPUT=Config(num_out),
                   FLAGVALS=Config({"image": TASK_META["image"]["interp"]}),
                   INFER_FLAGVALS=Config())
    other: Dict[str, Any] = {}
    for name in names:
        meta = TASK_META[name]
        if "interp" in meta:
            tasks.FLAGVALS[name] = meta["interp"]
        if "infer_interp" in meta:
            tasks.INFER_FLAGVALS[name] = meta["infer_interp"]
        if name == "depth" and db_name == "Cityscapes3D":
            tasks.depth_max = 80.0
            tasks.depth_min = 0.0
        if name == "edge":
            other["edge_w"] = task_dictionary["edge_w"]
            other["eval_edge"] = False
    return tasks, other


def create_config(exp_file: str, params: Dict[str, Any] | None = None,
                  run_mode: str = "train") -> Config:
    """A YAML experiment file -> Config: every key of the file, the task
    table, the database's scales, the output paths under
    ``out_dir/version_name`` (made unless ``run_mode`` is ``infer``), the
    detection parameters under ``det_cfg`` for ``3ddet``, the defaults of
    the optional keys, then ``params`` on top."""
    params = dict(params or {})
    params.setdefault("run_mode", run_mode)
    with open(exp_file, "r") as stream:
        cfg = Config.wrap(load_yaml(stream.read()))

    root_dir = os.path.join(cfg["out_dir"], cfg["version_name"])
    cfg.TASKS, extra = parse_task_dictionary(cfg["train_db_name"],
                                             cfg["task_dictionary"])
    cfg.update(extra)
    db = cfg["train_db_name"]
    if db not in DB_SCALES:
        raise NotImplementedError(f"Unknown database {db}")
    train_scale, test_scale = DB_SCALES[db]
    cfg.TRAIN = Config(SCALE=tuple(train_scale))
    cfg.TEST = Config(SCALE=tuple(test_scale))
    if db == "Cityscapes3D":
        cfg.IMAGE_ORI_SIZE = (1024, 2048)

    cfg["root_dir"] = root_dir
    cfg["output_dir"] = root_dir
    cfg["save_dir"] = os.path.join(root_dir, "results")
    cfg["checkpoint"] = os.path.join(root_dir, "checkpoint")
    if params["run_mode"] != "infer":
        os.makedirs(cfg["output_dir"], exist_ok=True)
        os.makedirs(cfg["save_dir"], exist_ok=True)

    if "3ddet" in cfg.TASKS.NAMES:
        from mtt_tpu_torch.detection.det_params import default_det_params
        det = Config.wrap(default_det_params(num_classes=6))
        # the strides are the original 1024x2048 image's: scaled by the
        # dataset's downscale and the model's img_ds_ratio resize
        ds_ratio = cfg.IMAGE_ORI_SIZE[0] // cfg.TRAIN.SCALE[0]
        det.strides = tuple(s * ds_ratio / cfg.get("img_ds_ratio", 1.0)
                            for s in det.strides)
        cfg.det_cfg = det

    for key, value in (("ignore_index", 255),
                       ("intermediate_supervision", False),
                       ("use_ctr", False), ("prompt_len", 1),
                       ("chan_nheads", 1), ("img_ds_ratio", 1.0),
                       ("fea_ds_ratio", 1), ("overfit", False)):
        cfg.setdefault(key, value)
    cfg.update(params)
    return cfg


# --- the YAML subset ---------------------------------------------------------

# PyYAML's implicit resolvers (YAML 1.1) for the plain scalars the subset
# takes; a plain scalar that another YAML 1.1 rule would read as a number
# (octal, hexadecimal, binary, base 60) raises
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "+.Inf": float("inf"), "+.INF": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}
_OTHER_NUMBER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                           r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")


def _plain(text: str, where: str) -> Any:
    if text in _BOOL:
        return _BOOL[text]
    if text in _NULL:
        return None
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _OTHER_NUMBER.match(text) or text[0] in "&*!|>%@`[]{},?-\"'" or \
            ": " in text or text.endswith(":") or " #" in text:
        raise ValueError(f"YAML {where}: {text!r} is outside the subset "
                         f"this reader takes")
    return text


def _quoted(text: str, where: str) -> str:
    q = text[0]
    if len(text) < 2 or text[-1] != q:
        raise ValueError(f"YAML {where}: unterminated string {text!r}")
    body = text[1:-1]
    if q == "'":
        if "'" in body.replace("''", ""):
            raise ValueError(f"YAML {where}: stray quote in {text!r}")
        return body.replace("''", "'")
    if "\\" in body or '"' in body:
        raise ValueError(f"YAML {where}: escapes are outside the subset "
                         f"({text!r})")
    return body


def _split_flow(body: str, where: str) -> List[str]:
    """The comma-separated items of a flow collection's body, each item's
    own brackets and quotes kept whole."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
            if depth < 0:
                raise ValueError(f"YAML {where}: unbalanced {body!r}")
        elif ch == "," and depth == 0:
            items.append(body[start:i].strip())
            start = i + 1
    if quote or depth:
        raise ValueError(f"YAML {where}: unbalanced {body!r}")
    last = body[start:].strip()
    if last:
        items.append(last)
    if any(not it for it in items):
        raise ValueError(f"YAML {where}: empty item in {body!r}")
    return items


def _flow_key(item: str, where: str) -> Tuple[str, str]:
    """A flow mapping item 'key: value' split at its first ': ' outside
    quotes."""
    quote = None
    for i, ch in enumerate(item):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ":" and (i + 1 == len(item) or item[i + 1] == " "):
            return item[:i].strip(), item[i + 1:].strip()
    raise ValueError(f"YAML {where}: {item!r} is not a 'key: value' item")


def _value(text: str, where: str) -> Any:
    if text[0] in "'\"":
        return _quoted(text, where)
    if text[0] == "[":
        if text[-1] != "]":
            raise ValueError(f"YAML {where}: unterminated list {text!r}")
        return [_value(it, where) for it in _split_flow(text[1:-1], where)]
    if text[0] == "{":
        if text[-1] != "}":
            raise ValueError(f"YAML {where}: unterminated mapping {text!r}")
        out = {}
        for it in _split_flow(text[1:-1], where):
            k, v = _flow_key(it, where)
            out[_value(k, where)] = _value(v, where) if v else None
        return out
    return _plain(text, where)


def _strip_comment(line: str) -> str:
    """The line without its comment: '#' at the start or after a blank,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def load_yaml(text: str) -> Dict[str, Any]:
    """The mapping of a YAML document in the subset described above, as
    ``yaml.safe_load`` would read it."""
    root: Dict[str, Any] = {}
    # (indent of the mapping's keys, the mapping); a key with no value opens
    # a child mapping whose indent the next line fixes
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]
    pending = None                    # (parent mapping, key) awaiting a child
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"YAML {where}: tab indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ValueError(f"YAML {where}: document markers are outside "
                             f"the subset")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if pending is not None:
            parent, key = pending
            if indent > stack[-1][0]:
                child: Dict[str, Any] = {}
                parent[key] = child
                stack.append((indent, child))
            else:
                parent[key] = None
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"YAML {where}: indentation {indent} matches no "
                             f"open mapping")
        if body.startswith("- ") or body == "-":
            raise ValueError(f"YAML {where}: block sequences are outside the "
                             f"subset")
        key_text, value_text = _flow_key(body, where)
        if not key_text:
            raise ValueError(f"YAML {where}: empty key")
        key = _value(key_text, where)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"YAML {where}: duplicate key {key!r}")
        if value_text:
            mapping[key] = _value(value_text, where)
        else:
            pending = (mapping, key)
    if pending is not None:
        pending[0][pending[1]] = None
    return root
