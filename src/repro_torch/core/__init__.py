"""Delta math, calibration stage 0, loader and store of the port."""
