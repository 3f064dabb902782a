"""RecSys: the embedding bag and the SASRec sequential recommender
(serving and training)."""

from repro_torch.models.recsys.embedding import embedding_bag
from repro_torch.models.recsys.sasrec import (
    SASRec,
    SASRecConfig,
    init_sasrec,
    sasrec_score_candidates,
    sasrec_train_loss,
    sasrec_user_state,
)

__all__ = ["embedding_bag", "SASRec", "SASRecConfig", "init_sasrec",
           "sasrec_score_candidates", "sasrec_train_loss",
           "sasrec_user_state"]
