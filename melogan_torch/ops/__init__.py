"""Kernels of the port and their plain PyTorch versions.

- ``convt.py``: transposed conv1d (``csrc/convt1d.cu``)
- ``conv1d.py``: strided conv1d (``csrc/conv1d.cu``)
- ``igemm.py``: the geometry the conv kernels and the decoder tail share
  (the 3xTF32 core ``csrc/igemm_tf32x3.cuh`` and the one-pass bf16 core
  ``csrc/igemm_bf16.cuh``)
- ``decoder.py``: the fused generator-decoder tail (``csrc/decoder_tail.cu``,
  three launches of the 3xTF32 core on W' held with the folded weights)
- ``conv.py``: the conv front end the models call
- ``_build.py``: builds ``csrc/*.cu`` with nvcc and loads them with ctypes
"""
