"""Minimal COCO-keypoints json accessor (pycocotools-free).

The port's own copy of vatl4pose_tpu/data/coco_json.py: the AL pipeline
only needs id-indexed access over plain json.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


class CocoJson:
    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, (str,)):
            with open(path_or_dict) as f:
                self.dataset = json.load(f)
        else:
            self.dataset = path_or_dict
        self.imgs: Dict[Any, dict] = {}
        self.anns: Dict[Any, dict] = {}
        self.img_to_anns: Dict[Any, List[dict]] = {}
        for img in self.dataset.get("images", []):
            iid = img.get("id", img.get("image_id"))
            img.setdefault("image_id", iid)
            img.setdefault("id", iid)
            self.imgs[iid] = img
            self.img_to_anns.setdefault(iid, [])
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns.setdefault(ann["image_id"], []).append(ann)

    @property
    def categories(self):
        return self.dataset.get("categories", [])

    def cat_names(self):
        return [c["name"] for c in self.categories]

    def img_ids(self):
        return sorted(self.imgs)

    def load_img(self, iid):
        return self.imgs[iid]

    def anns_of(self, iid):
        return self.img_to_anns.get(iid, [])
