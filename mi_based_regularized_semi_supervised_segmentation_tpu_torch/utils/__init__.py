from .general import class2one_hot, flatten_dict, gethash, set_seed
from .meters import (
    AverageValueMeter,
    MeterInterface,
    MultipleAverageValueMeter,
    Storage,
    StorageIncomeDict,
    UniversalDice,
)
from .writer import SummaryWriter

__all__ = [
    "class2one_hot",
    "flatten_dict",
    "gethash",
    "set_seed",
    "AverageValueMeter",
    "MeterInterface",
    "MultipleAverageValueMeter",
    "Storage",
    "StorageIncomeDict",
    "UniversalDice",
    "SummaryWriter",
]
