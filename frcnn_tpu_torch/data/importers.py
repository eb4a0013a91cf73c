"""Dataset importers (the JAX package's ``data/importers.py``): CSV (duplo),
ILSVRC2015-DET XML and reference ``.t7`` training data -> JSON manifest.

Replaces ``create-duplo-traindata.lua`` and ``create-imagenet-traindata.lua``
(t7 serialization) with a JSON manifest carrying the same fields:
``dataset_name, ground_truth, training_set, validation_set, class_names,
class_index, background_files``.

Class indices here are 0-based (the Lua tables are 1-based); background is
class_count in model space and never appears in a manifest.

Reference bugs deliberately NOT replicated (SURVEY.md §7): the imagenet
importer's debug early-exit after >10 entries
(``create-imagenet-traindata.lua:74-76``) and its hardcoded personal paths.
"""

from __future__ import annotations

import json
import os
import random
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Tuple


def _strip_quotes(s: str) -> str:
    s = s.strip()
    if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
        return s[1:-1]
    return s


def read_csv_rois(csv_path: str) -> Tuple[Dict, List[str], Dict[str, int]]:
    """Parse the duplo ROI CSV: ``filename, left, top, right, bottom,
    class_name, class_index, material_name, material_index`` — a trivial
    format with no commas inside values (``create-duplo-traindata.lua:7-46``).
    Class vocabulary is built in first-seen order."""
    ground_truth: Dict[str, dict] = {}
    class_names: List[str] = []
    class_index: Dict[str, int] = {}
    with open(csv_path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            v = line.split(",")
            class_name = _strip_quotes(v[5])
            if class_name not in class_index:
                class_index[class_name] = len(class_names)
                class_names.append(class_name)
            fn = _strip_quotes(v[0])
            roi = {
                "rect": [float(v[1]), float(v[2]), float(v[3]), float(v[4])],
                "class_name": class_name,
                "class_index": class_index[class_name],
            }
            entry = ground_truth.setdefault(
                fn, {"image_file_name": fn, "rois": []}
            )
            entry["rois"].append(roi)
    return ground_truth, class_names, class_index


def _split_train_val(file_names: List[str], validation_size: float,
                     rng: random.Random) -> Tuple[List[str], List[str]]:
    """Shuffled 80:20 (default) split (``create-duplo-traindata.lua:53-59``)."""
    names = list(file_names)
    rng.shuffle(names)
    if 0 <= validation_size < 1:
        n_val = int(-(-len(names) * validation_size // 1))  # ceil
    else:
        n_val = int(validation_size)
    return names[n_val:], names[:n_val]


def _list_files(directory: Optional[str], suffixes: Optional[Sequence[str]] = None,
                abspath: bool = False) -> List[str]:
    if not directory or not os.path.isdir(directory):
        return []
    out = []
    for fn in sorted(os.listdir(directory)):
        full = os.path.join(directory, fn)
        if not os.path.isfile(full):
            continue
        if suffixes and not fn.lower().endswith(tuple(suffixes)):
            continue
        out.append(full if abspath else fn)
    return out


def create_duplo_manifest(dataset_name: str, csv_file: str,
                          background_dir: Optional[str],
                          output_path: Optional[str] = None,
                          validation_size: float = 0.2,
                          seed: int = 0) -> dict:
    ground_truth, class_names, class_index = read_csv_rois(csv_file)
    train, val = _split_train_val(
        list(ground_truth.keys()), validation_size, random.Random(seed)
    )
    manifest = {
        "dataset_name": dataset_name,
        "ground_truth": ground_truth,
        "training_set": train,
        "validation_set": val,
        "class_names": class_names,
        "class_index": class_index,
        "background_files": _list_files(background_dir),
    }
    if output_path:
        save_manifest(manifest, output_path)
    return manifest


# --- ILSVRC2015 DET ---------------------------------------------------------

def _import_xml_file(fn: str, anno_base: str, data_base: str,
                     ground_truth: dict, class_names: List[str],
                     class_index: Dict[str, int], name_list: List[str]):
    """Parse one PASCAL-style annotation
    (``create-imagenet-traindata.lua:13-62``): every <object> yields a ROI;
    the image path is the annotation path rebased onto the data dir with the
    extension swapped to .JPEG."""
    root = ET.parse(fn).getroot()
    rel = os.path.relpath(fn, anno_base)
    image_path = os.path.join(data_base, rel[:-3] + "JPEG")
    for obj in root.iter("object"):
        name_el = obj.find("name")
        bb = obj.find("bndbox")
        if name_el is None or bb is None:
            continue
        name = name_el.text
        if name not in class_index:
            class_index[name] = len(class_names)
            class_names.append(name)
        roi = {
            "rect": [
                float(bb.find("xmin").text), float(bb.find("ymin").text),
                float(bb.find("xmax").text), float(bb.find("ymax").text),
            ],
            "class_name": name,
            "class_index": class_index[name],
        }
        entry = ground_truth.get(image_path)
        if entry is None:
            entry = {"image_file_name": image_path, "rois": []}
            ground_truth[image_path] = entry
        name_list.append(image_path)
        entry["rois"].append(roi)


def create_imagenet_manifest(dataset_name: str, base_dir: str,
                             train_annotation_dir: str, val_annotation_dir: str,
                             train_data_dir: str, val_data_dir: str,
                             background_dirs: Sequence[str] = (),
                             output_path: Optional[str] = None) -> dict:
    """Recursively import ILSVRC2015-DET annotations
    (``create-imagenet-traindata.lua:82-127``)."""
    ground_truth: Dict[str, dict] = {}
    class_names: List[str] = []
    class_index: Dict[str, int] = {}
    training_set: List[str] = []
    validation_set: List[str] = []

    def walk(anno_dir: str, data_dir: str, into: List[str]):
        for dirpath, _dirs, files in os.walk(os.path.join(base_dir, anno_dir)):
            for fn in sorted(files):
                if fn.lower().endswith(".xml"):
                    _import_xml_file(
                        os.path.join(dirpath, fn),
                        os.path.join(base_dir, anno_dir),
                        os.path.join(base_dir, data_dir),
                        ground_truth, class_names, class_index, into,
                    )

    walk(train_annotation_dir, train_data_dir, training_set)
    walk(val_annotation_dir, val_data_dir, validation_set)

    background_files: List[str] = []
    for d in background_dirs:
        background_files.extend(
            _list_files(os.path.join(base_dir, d), suffixes=(".jpeg",), abspath=True)
        )

    manifest = {
        "dataset_name": dataset_name,
        "ground_truth": ground_truth,
        "training_set": training_set,
        "validation_set": validation_set,
        "class_names": class_names,
        "class_index": class_index,
        "background_files": background_files,
    }
    if output_path:
        save_manifest(manifest, output_path)
    return manifest


def create_manifest_from_t7(t7_path: str,
                            output_path: Optional[str] = None) -> dict:
    """Convert a reference training-data ``.t7`` file (the schema written by
    ``create-duplo-traindata.lua:68-79`` / ``create-imagenet-traindata.lua:
    109-120``) into the JSON manifest, so datasets prepared for
    the Torch7 reference can be used directly. Lua's 1-based class indices
    become 0-based; ``Rect`` objects become ``[minx, miny, maxx, maxy]``."""
    from frcnn_tpu_torch.data import t7

    raw = t7.load(t7_path)
    if not isinstance(raw, dict) or "ground_truth" not in raw:
        raise ValueError(f"{t7_path} is not a reference training-data file")

    def rect_to_list(r):
        state = r.state if isinstance(r, t7.TorchObject) else r
        return [float(state["minX"]), float(state["minY"]),
                float(state["maxX"]), float(state["maxY"])]

    ground_truth = {}
    for fn, entry in raw["ground_truth"].items():
        rois = []
        for roi in entry["rois"].list():
            rois.append({
                "rect": rect_to_list(roi["rect"]),
                "class_name": roi.get("class_name", ""),
                "class_index": int(roi["class_index"]) - 1,
            })
        ground_truth[fn] = {
            "image_file_name": entry.get("image_file_name", fn), "rois": rois
        }

    manifest = {
        "dataset_name": raw.get("dataset_name", "t7-import"),
        "ground_truth": ground_truth,
        "training_set": [str(x) for x in raw["training_set"].list()],
        "validation_set": [str(x) for x in raw["validation_set"].list()],
        "class_names": [str(x) for x in raw["class_names"].list()],
        "class_index": {
            str(k): int(v) - 1 for k, v in raw["class_index"].items()
        },
        "background_files": [
            str(x) for x in raw.get("background_files", t7.LuaTable()).list()
        ],
    }
    if output_path:
        save_manifest(manifest, output_path)
    return manifest


def save_manifest(manifest: dict, path: str):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, path)


def load_manifest(path: str) -> dict:
    with open(path, "r") as f:
        return json.load(f)
