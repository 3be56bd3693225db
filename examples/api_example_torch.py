"""Library API walkthrough of the PyTorch port, step for step the same as
examples/api_example.py (and the reference's api_examples/api_example.cpp):
build, search, streaming_search, reconstruct_all_kmers and the
select-supported get_kmer_fast. It prints the same lines.

Run from the repo root:  python examples/api_example_torch.py [--device cpu]
(the default device is cuda: the index and its queries run the CUDA
kernels; cpu runs their plain PyTorch versions).
"""
import argparse
import os
import sys

here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(here))  # repo root, when run in place

from sbwt_tpu_torch.io import seqio
from sbwt_tpu_torch.models.sbwt import SBWT

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda")
device = parser.parse_args().device

k = 6

# Build the index (api_example.cpp:12-24): streaming support on, all
# 4^4 4-mer intervals precalculated.
seqs = [s.decode() for s in seqio.read_sequences(os.path.join(here, "sequences.fna"))]
sbwt = SBWT.build(seqs, k, device, streaming_support=True, precalc_k=4)

# Search for k-mer GATGGC (api_example.cpp:26-27)
print(sbwt.search("GATGGC"))

# Search for all k-mers of TAATGCTGTAGC (api_example.cpp:29-32)
for colex_rank in sbwt.streaming_search("TAATGCTGTAGC"):
    print(colex_rank)

# Dump all k-mers out of the data structure at once (fast)
# (api_example.cpp:34-42); dummies start with '$'
kmer_dump = sbwt.reconstruct_all_kmers()
for i in range(0, len(kmer_dump), k):
    kmer = kmer_dump[i : i + k]
    if kmer[0] != "$":
        print(kmer)
print("--")

# List k-mers one by one through the select support
# (api_example.cpp:44-53)
ss = sbwt.select_support()
for i in range(sbwt.number_of_subsets()):
    kmer = sbwt.get_kmer_fast(i, ss)
    if kmer[0] != "$":
        print(kmer)
