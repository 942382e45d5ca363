"""A configuration file's ``model`` group as the attributes the plain
reference reads (the same names as the program's config, derived here)."""

from __future__ import annotations


class Geometry:
    def __init__(self, m: dict):
        self.m = m
        self.insize = tuple(m["insize"])
        self.outsize = tuple(m["outsize"])
        self.local_grid_size = tuple(m["local_grid_size"])
        self.edges = tuple(tuple(e) for e in m["edges"])
        self.flip_pairs = tuple(tuple(e) for e in m["flip_pairs"])
        for k in ("instance_scale", "parts_scale", "lambda_resp",
                  "lambda_iou", "lambda_coor", "lambda_size", "lambda_limb",
                  "detection_thresh", "nms_thresh", "min_num_keypoints",
                  "max_instances", "size_activation", "limb_loss_mode"):
            setattr(self, k, m[k])
        self.num_classes = len(m["keypoint_names"])
        self.num_keypoints = self.num_classes - 1
        self.num_limbs = len(self.edges)
        self.stride = (self.insize[0] / self.outsize[0],
                       self.insize[1] / self.outsize[1])
        hl, wl = self.local_grid_size
        self.num_channels = 6 * self.num_classes + self.num_limbs * hl * wl
