"""Cold-bundle storage dtypes: byte accounting (`quantize.py`) and the
int8 / int4-mixed bundle quantizers of the serving plane (`storage.py`)."""
