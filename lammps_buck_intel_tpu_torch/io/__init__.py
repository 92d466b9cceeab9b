from . import data_reader, lattice, velocity
from .data_reader import DataFile, read_data
