"""Models: the dense decoder-only LM (`transformer`), the SASRec
recommender and its embedding bag (`recsys`), and their building blocks
(`common`)."""
