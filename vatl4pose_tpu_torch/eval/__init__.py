"""Evaluation on the host: COCO keypoint mAP, OSPA, JRDB AP, tracking
metrics."""

from .cocoeval import STAT_KEYS, evaluate_map
from .jrdb_ap import average_precision_for_loc
from .ospa import get_ospa, ospa_for_loc
from .tracking import clear, evaluate_tracking, hota, identity, ospa2
