"""Data layer: COCO-json video datasets, the extra loaders, the AE's
whole-body features and the synthetic fixtures."""

from .coco_json import CocoJson
from .dataset import (JRDB2022, Posetrack21, VideoPoseData, VideoPoseDataset,
                      build_dataset)
from .extra_datasets import ConcatDataset, Mpii, Mscoco, Mscoco_det
from .pipeline import (AugCfg, bucket_size, eval_sample_geometry, pad_to,
                       train_sample_geometry)
from .synthetic import make_synthetic_multivideo, make_synthetic_video
from .wholebody import Wholebody
