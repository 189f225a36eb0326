"""STFT front end, masks, windowing and the fused row-block kernel."""
