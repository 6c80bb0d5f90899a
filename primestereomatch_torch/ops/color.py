"""Colour conversion and the ksize-1 horizontal Sobel gradient
(reference CVC preprocessing, src/CVC.cpp:41-46).

Two reference quirks are kept: the images are BGR but are converted with
CV_RGB2GRAY weights, so 0.299 lands on blue; and Sobel with ksize=1 is the
central difference [-1, 0, 1] with reflect-101 borders, which is 0 on the
first and last column. The uint8 versions are the host prep of the
reference's uchar OpenCL cost (src/CVC_cl.cpp:125-131), for
`GIFConfig(cvc_dtype='u8')`; they are integer and bitwise.
"""

from __future__ import annotations

import torch

# OpenCV R2YF/G2YF/B2YF constants, applied to channels 0,1,2 as stored.
_CVT_W = (0.299, 0.587, 0.114)


def bgr_to_gray_refquirk(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) float -> (..., H, W) gray, same term order as the
    JAX op."""
    return (
        img[..., 0] * _CVT_W[0]
        + img[..., 1] * _CVT_W[1]
        + img[..., 2] * _CVT_W[2]
    )


def sobel_x_k1(gray: torch.Tensor) -> torch.Tensor:
    """cv::Sobel(dx=1, dy=0, ksize=1) along the last axis, reflect-101."""
    left = torch.cat([gray[..., 1:2], gray[..., :-1]], dim=-1)
    right = torch.cat([gray[..., 1:], gray[..., -2:-1]], dim=-1)
    return right - left


def bgr_to_gray_refquirk_u8(img_u8: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) uint8 -> (..., H, W) uint8 gray with OpenCV's 8-bit
    CV_RGB2GRAY on BGR-ordered data: 14-bit fixed-point coefficients,
    round half up, (c0*4899 + c1*9617 + c2*1868 + 8192) >> 14."""
    x = img_u8.to(torch.int32)
    return ((x[..., 0] * 4899 + x[..., 1] * 9617 + x[..., 2] * 1868 + (1 << 13))
            >> 14).to(torch.uint8)


def sobel_x_k1_u8(gray_u8: torch.Tensor) -> torch.Tensor:
    """cv::Sobel(..., CV_8U, 1, 0, 1) on uint8: the central difference with
    reflect-101 borders, saturated to [0, 255] (negative gradients are 0)."""
    x = gray_u8.to(torch.int32)
    return sobel_x_k1(x).clamp(0, 255).to(torch.uint8)
