"""XPose / UniPose open-vocabulary keypoint detector (animal landmarks).

Port of ``canonswap_tpu/models/xpose``: Swin-T backbone, a 4-level
deformable transformer with vision<->text fusion, two-stage query selection
and the keypoint-group decoder.  The deformable attention is the CUDA kernel
``csrc/ms_deform_attn.cu`` on the card.
"""
