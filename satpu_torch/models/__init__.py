"""Model zoo of the serving path: TDNN-F ASR-BN, HiFi-GAN, the anonymizer."""
