from repro_torch.train.step import chunked_softmax_xent, loss_fn, make_train_step

__all__ = ["chunked_softmax_xent", "loss_fn", "make_train_step"]
