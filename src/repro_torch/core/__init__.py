"""The paper's datapath: LFSR source, fitness programs, GA operators."""
