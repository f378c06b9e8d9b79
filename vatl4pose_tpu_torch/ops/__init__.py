"""Core numerics on tensors (counterpart of vatl4pose_tpu/ops)."""

from .affine import (affine_transform_points, bbox_xyxy_to_xywh,
                     box_to_center_scale, center_scale_to_box,
                     get_affine_transform, transform_preds)
from .heatmap import (crop_to_image, gaussian_target, get_max_pred,
                      heatmap_to_coord, subpixel_refine)
from .hybrid import ANGLE_TRIANGLES_17, compute_hybrid
from .oks import (COCO_SIGMAS, COCO_VARS, JRDB_SIGMAS, JRDB_VARS, compute_oks,
                  oks_matrix)
from .peaks import (compute_entropy, compute_margin, compute_mpe,
                    localpeak_mean, max_filter2d, peak_local_max_topk)
from .temporal import temporal_neighbor_weights, thc_scores, tpc_scores
from .warp import (RGB_MEAN, crop_batch, crop_geometry, normalize_crops,
                   warp_affine_bilinear, warp_affine_bilinear_batch,
                   warp_axis_aligned_batch)
