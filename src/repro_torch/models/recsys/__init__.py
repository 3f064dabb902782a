"""RecSys: the embedding bag and the SASRec sequential recommender
(serving; `sasrec_train_loss` waits for the training slice)."""

from repro_torch.models.recsys.embedding import embedding_bag
from repro_torch.models.recsys.sasrec import (
    SASRec,
    SASRecConfig,
    init_sasrec,
    sasrec_score_candidates,
    sasrec_user_state,
)

__all__ = ["embedding_bag", "SASRec", "SASRecConfig", "init_sasrec",
           "sasrec_score_candidates", "sasrec_user_state"]
