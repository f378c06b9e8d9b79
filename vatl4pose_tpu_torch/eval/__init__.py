"""Evaluation on the host: COCO keypoint mAP and OSPA."""

from .cocoeval import STAT_KEYS, evaluate_map
from .ospa import get_ospa, ospa_for_loc
