"""One intra-op thread for torch in the port's CPU tests.

The port's tests run at smoke sizes, where a torch op takes microseconds.
By default torch runs each op on one OpenMP thread per core, and the
threads spin while they wait, so pytest-xdist's workers, each with a
full set of threads, take the cores from one another. Importing this
module sets one intra-op thread in the importing process. Every CPU
test module of the port imports it, and each xdist worker imports every
test module when it collects, so the setting holds for the whole run.
"""
import torch

torch.set_num_threads(1)
