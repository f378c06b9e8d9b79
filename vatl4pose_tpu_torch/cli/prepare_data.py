"""Dataset preparation (counterpart of vatl4pose_tpu/cli/prepare_data.py;
parity: data/PoseTrack21/make_new_annotation.py,
integrate_new_annotation.py, data/jrdb-pose/make_new_annotation.py).

    python -m vatl4pose_tpu_torch.cli.prepare_data posetrack-val \
        --root data/PoseTrack21

Host-only JSON work: no device is involved.  The image sizes come from
the JPEG, PNG and BMP headers and a TIFF's first IFD (data/image_io.py: no
cv2, which the machine with the card does not have); the integrate
subcommand reads no image.

Subcommands:
  posetrack-val      extract ~30 densely-labeled center frames per val video
                     (make_new_annotation.py:6-49)
  posetrack-train    add width/height to train jsons (:51-87)
  integrate          merge per-video jsons into 000000_integrated_<mode>.json
                     with area/iscrowd fields (integrate_new_annotation.py)
  jrdb               re-key JRDB stitched-image annotations into COCO-format
                     per-scene jsons with composite 7-digit image ids
"""

from __future__ import annotations

import argparse
import glob
import json
import os

__all__ = ["posetrack_val", "posetrack_train", "integrate", "jrdb", "main"]


def _img_size(path):
    """(width, height) as cv2.imread's decode would have them."""
    from ..data.image_io import image_size
    return image_size(path)


def posetrack_val(root: str):
    src = os.path.join(root, "posetrack_data", "val")
    dst = os.path.join(root, "activelearning", "val")
    os.makedirs(dst, exist_ok=True)
    for f in sorted(glob.glob(os.path.join(src, "*.json"))):
        with open(f) as fh:
            data = json.load(fh)
        center_frame = int(data["images"][0]["nframes"] / 2)
        vid_id = data["images"][0]["vid_id"]
        center_id = int(f"1{vid_id}{center_frame:04d}")
        images = []
        for image in data["images"]:
            if (center_id - 17 < image["image_id"] < center_id + 17
                    and image["is_labeled"]):
                w, h = _img_size(os.path.join(root, image["file_name"]))
                image["width"] = w
                image["height"] = h
                images.append(image)
        keep = {im["image_id"] for im in images}
        anns = [a for a in data["annotations"] if a["image_id"] in keep]
        out = {"images": images, "annotations": anns,
               "categories": data["categories"]}
        with open(os.path.join(dst, os.path.basename(f)), "w") as fh:
            json.dump(out, fh)
        print(f"{os.path.basename(f)}: {len(images)} dense frames")


def posetrack_train(root: str, mode: str):
    src = os.path.join(root, "posetrack_data", mode)
    dst = os.path.join(root, "activelearning", mode)
    os.makedirs(dst, exist_ok=True)
    for f in sorted(glob.glob(os.path.join(src, "*.json"))):
        with open(f) as fh:
            data = json.load(fh)
        for image in data["images"]:
            w, h = _img_size(os.path.join(root, image["file_name"]))
            image["width"] = w
            image["height"] = h
        # rebuild with exactly the three keys the reference emits
        # (make_new_annotation.py:60-88 builds a fresh seq_dict)
        out = {"images": data["images"], "annotations": data["annotations"],
               "categories": data["categories"]}
        with open(os.path.join(dst, os.path.basename(f)), "w") as fh:
            json.dump(out, fh)


def integrate(root: str, mode: str):
    src = os.path.join(root, "activelearning", mode)
    out = {"images": [], "annotations": [], "categories": []}
    ann_cnt = 0
    files = [f for f in sorted(glob.glob(os.path.join(src, "*.json")))
             if "000000" not in os.path.basename(f)]
    for i, f in enumerate(files):
        with open(f) as fh:
            data = json.load(fh)
        if i == 0:
            out["categories"] = data["categories"]
        keep = set()
        for img in data["images"]:
            if img.get("is_labeled", True):
                keep.add(img["image_id"])
                out["images"].append(img)
        for ann in data["annotations"]:
            if ann["image_id"] in keep:
                ann["iscrowd"] = 0
                ann["area"] = ann["bbox"][2] * ann["bbox"][3]
                out["annotations"].append(ann)
                ann_cnt += 1
    path = os.path.join(src, f"000000_integrated_{mode}.json")
    with open(path, "w") as fh:
        json.dump(out, fh)
    print(f"{ann_cnt} annotations -> {path}")


def jrdb(root: str, split: str, scene_list: str):
    """Re-key JRDB-Pose stitched-image annotations into per-scene COCO jsons
    (parity: data/jrdb-pose/make_new_annotation.py:6-92).

    Raw layout (the JRDB2022 release):
      {root}/jrdb2022/labels/labels_2d_pose_stitched_coco/{seq}.json  pose
      {root}/jrdb2022/labels/labels_2d_stitched/{seq}.json            boxes
    Output: {root}/activelearning/{split}/{seq_id:02d}_jrdb-pose.json with
    8-digit composite image ids int('1' + 2-digit seq + 5-digit frame),
    annotation ids suffixed with the 3-digit track id, keypoint visibility
    squashed to {0, 1.0}, and bbox/area taken from the detection labels'
    matching "pedestrian:<track_id>" entry.
    """
    with open(scene_list) as fh:
        scenes = [s.strip() for s in fh if s.strip()]
    label_root = os.path.join(root, "jrdb2022", "labels")
    dst = os.path.join(root, "activelearning", split)
    os.makedirs(dst, exist_ok=True)
    for seq_cnt, scene in enumerate(scenes):
        seq_id = f"{seq_cnt:02d}"
        with open(os.path.join(label_root, "labels_2d_stitched",
                               f"{scene}.json")) as fh:
            d_det = json.load(fh)
        with open(os.path.join(label_root, "labels_2d_pose_stitched_coco",
                               f"{scene}.json")) as fh:
            d_pose = json.load(fh)
        images, anns = [], []
        seen = set()
        wh = None
        for k, d_ann in enumerate(d_pose["annotations"]):
            image_id = d_ann["image_id"]
            if image_id >= 150:      # ref caps at 150 frames per scene
                continue
            d_image = d_pose["images"][image_id - 1]
            base = d_image["file_name"].split("/")[-1]
            new_image_id = int(f"1{seq_id}{image_id:05d}")
            if image_id not in seen:
                seen.add(image_id)
                if wh is None:       # ref reads size once (k==0 frame)
                    w, h = _img_size(os.path.join(
                        root, "images", d_image["file_name"]))
                    wh = (w, h)
                images.append({
                    "id": new_image_id, "image_id": new_image_id,
                    "vid_id": seq_id,
                    "file_name": "images/" + d_image["file_name"],
                    "is_labeled": True, "has_labeled_person": True,
                    "height": wh[1], "width": wh[0]})
            track_id = d_ann["track_id"]
            ann = {"track_id": track_id, "image_id": new_image_id,
                   "category_id": d_ann["category_id"],
                   "num_keypoints": d_ann["num_keypoints"],
                   "is_crowd": 0,
                   "id": int(str(new_image_id) + str(track_id).zfill(3))}
            kps = list(d_ann["keypoints"])
            for i in range(2, len(kps), 3):
                kps[i] = 0 if kps[i] == 0 else 1.0
            ann["keypoints"] = kps
            for person in d_det["labels"][base]:
                if person["label_id"] == "pedestrian:" + str(track_id):
                    ann["bbox"] = person["box"]
                    ann["area"] = person["attributes"]["area"]
                    anns.append(ann)
                    break
        out = {"images": images, "annotations": anns,
               "categories": d_pose["categories"]}
        with open(os.path.join(dst, f"{seq_id}_jrdb-pose.json"), "w") as fh:
            json.dump(out, fh)
        print(f"{scene} -> {seq_id}_jrdb-pose.json ({len(images)} frames)")


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    s1 = sub.add_parser("posetrack-val")
    s1.add_argument("--root", default="data/PoseTrack21")
    s2 = sub.add_parser("posetrack-train")
    s2.add_argument("--root", default="data/PoseTrack21")
    s2.add_argument("--mode", default="train")
    s3 = sub.add_parser("integrate")
    s3.add_argument("--root", default="data/PoseTrack21")
    s3.add_argument("--mode", default="val")
    s4 = sub.add_parser("jrdb")
    s4.add_argument("--root", default="data/jrdb-pose")
    s4.add_argument("--split", default="test")
    s4.add_argument("--scene_list", required=True)
    a = p.parse_args(argv)
    if a.cmd == "posetrack-val":
        posetrack_val(a.root)
    elif a.cmd == "posetrack-train":
        posetrack_train(a.root, a.mode)
    elif a.cmd == "integrate":
        integrate(a.root, a.mode)
    elif a.cmd == "jrdb":
        jrdb(a.root, a.split, a.scene_list)


if __name__ == "__main__":
    main()
