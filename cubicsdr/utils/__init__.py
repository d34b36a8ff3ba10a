from cubicsdr.utils.convolve import conv1d, frame_signal  # noqa: F401
