from .nets import (Affine, BatchNormMLP, ConstantVector, DenseNet,
                   DenseNetRelu, DenseNetTanh, DenseNetTanh2, LinearLQ,
                   LinearLQTime, Module, ReluMLP1d, ScalarParam, Sines,
                   TanhMLP)

# Reference-name aliases (function_space.py class names)
SingleParam = ScalarParam
Constant = ConstantVector
Linear = LinearLQ
NN = BatchNormMLP
NN_Nik = ReluMLP1d
MySequential = TanhMLP
DenseNet_tanh = DenseNetTanh
DenseNet_tanh_2 = DenseNetTanh2

__all__ = [
    "Affine", "BatchNormMLP", "ConstantVector", "DenseNet", "DenseNetRelu",
    "DenseNetTanh",
    "DenseNetTanh2", "LinearLQ", "LinearLQTime", "Module", "ReluMLP1d",
    "ScalarParam", "Sines",
    "TanhMLP", "SingleParam", "Constant", "Linear", "NN", "NN_Nik",
    "MySequential", "DenseNet_tanh", "DenseNet_tanh_2",
]
