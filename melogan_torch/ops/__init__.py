"""Kernels of the port and their plain PyTorch versions.

- ``convt.py``: transposed conv1d (``csrc/convt1d.cu``)
- ``conv1d.py``: strided conv1d (``csrc/conv1d.cu``)
- ``igemm.py``: the geometry both conv kernels share (``csrc/igemm.cuh``)
- ``decoder.py``: the fused generator-decoder tail (``csrc/decoder_tail.cu``)
- ``conv.py``: the conv front end the models call
- ``_build.py``: builds ``csrc/*.cu`` with nvcc and loads them with ctypes
"""
