"""The plain reference the benchmark judges the program's outputs by.

Written from the published definitions alone: RS(k, m) over GF(2^8) as
klauspost/reedsolomon builds it (multiplication-table lookups), CRC32-C
(Castagnoli; float bit products, exact for 0/1 operands), the Go
encoder's block layout (weed/storage/erasure_coding/ec_encoder.go) and
its sorted index.  Plain NumPy and PyTorch, on the card or the CPU;
nothing here imports the program or JAX."""
