from ardae_tpu_torch.models.cdae.cardae import (
    MLPGradARDAE,
    MLPGradCARDAE,
    MLPGradCDAE,
    MLPGradDAE,
    MLPResARDAE,
    MLPResCARDAE,
    MLPResCDAE,
    MLPResDAE,
    cdae_loss,
    cdae_score,
    dae_loss,
    dae_score,
)
from ardae_tpu_torch.models.cdae.legacy import MLPCDAE, MLPDAE
