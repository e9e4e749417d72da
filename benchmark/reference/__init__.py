"""The benchmark's plain reference of Cap2Det: PyTorch operations only.

It imports nothing of the measured program. What the program derives
from the benchmark's weights and inputs (the folded weights, the dropout
draws, the OICR targets, the resized canvases, the detections), the
reference works out again.
"""
