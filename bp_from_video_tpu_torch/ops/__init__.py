"""Signal ring buffers, DSP chain, spectra, correlation and ROI sampling."""
