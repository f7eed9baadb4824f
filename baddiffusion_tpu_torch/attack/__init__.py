from baddiffusion_tpu_torch.attack.loss import backdoor_loss, q_sample_backdoor, reduce_loss

__all__ = ["backdoor_loss", "q_sample_backdoor", "reduce_loss"]
