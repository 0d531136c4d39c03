"""The Kaggle NDSB plankton convnet (a copy of
``cxxnet_tpu/models/bowl.py``): the net of the reference cxxnet's
``example/kaggle_bowl/bowl.conf``, as config text."""


def kaggle_bowl(nclass: int = 121, batch_size: int = 64) -> str:
    return """
netconfig=start
layer[+1] = conv
  kernel_size = 4
  stride = 1
  nchannel = 48
  pad = 2
layer[+1] = relu
layer[+1] = max_pooling
  kernel_size = 3
  stride = 2
layer[+1] = conv
  nchannel = 96
  kernel_size = 3
  stride = 1
  pad = 1
layer[+1] = relu
layer[+1] = conv
  nchannel = 96
  kernel_size = 3
  stride = 1
  pad = 1
layer[+1] = relu
layer[+1] = max_pooling
  kernel_size = 3
  stride = 2
layer[+1] = conv
  nchannel = 128
  kernel_size = 2
  stride = 1
layer[+1] = relu
layer[+1] = conv
  nchannel = 128
  kernel_size = 3
  stride = 1
layer[+1] = max_pooling
  kernel_size = 3
  stride = 2
layer[+1] = flatten
layer[+1] = fullc
  nhidden = 256
layer[+0] = dropout
  threshold = 0.5
layer[+1] = fullc
  nhidden = %d
layer[+0] = softmax
netconfig=end
input_shape = 3,40,40
batch_size = %d
eta = 0.01
momentum = 0.9
wd = 0.0005
random_type = xavier
metric = logloss
metric = error
""" % (nclass, batch_size)
