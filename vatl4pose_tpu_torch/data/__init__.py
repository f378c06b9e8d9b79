"""Data layer: COCO-json video datasets and the synthetic fixture."""

from .coco_json import CocoJson
from .dataset import (JRDB2022, Posetrack21, VideoPoseData, VideoPoseDataset,
                      build_dataset)
from .pipeline import bucket_size, pad_to
from .synthetic import make_synthetic_video
