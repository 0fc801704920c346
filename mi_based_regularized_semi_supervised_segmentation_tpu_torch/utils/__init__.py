from .general import ExceptionIgnorer, class2one_hot, flatten_dict, gethash, set_seed
from .meters import (
    AverageValueMeter,
    MeterInterface,
    MultipleAverageValueMeter,
    Storage,
    StorageIncomeDict,
    SurfaceMeter,
    UniversalDice,
)
from .writer import SummaryWriter

__all__ = [
    "ExceptionIgnorer",
    "class2one_hot",
    "flatten_dict",
    "gethash",
    "set_seed",
    "AverageValueMeter",
    "MeterInterface",
    "MultipleAverageValueMeter",
    "Storage",
    "StorageIncomeDict",
    "SurfaceMeter",
    "UniversalDice",
    "SummaryWriter",
]
