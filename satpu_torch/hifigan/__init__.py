"""HiFi-GAN training of the anonymization generator (port of
``satpu.hifigan``): the cached-feature dataset and the GAN trainer."""
