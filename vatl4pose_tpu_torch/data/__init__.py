"""Data layer: COCO-json video datasets and the synthetic fixture."""

from .coco_json import CocoJson
from .dataset import (JRDB2022, Posetrack21, VideoPoseData, VideoPoseDataset,
                      build_dataset)
from .pipeline import (AugCfg, bucket_size, eval_sample_geometry, pad_to,
                       train_sample_geometry)
from .synthetic import make_synthetic_video
