"""AlexNet (Krizhevsky et al. 2012) in the netconfig DSL.

A copy of ``cxxnet_tpu/models/alexnet.py``; its topology is the
reference cxxnet's ``example/ImageNet/ImageNet.conf`` (and this repo's
``example/ImageNet/AlexNet.conf``): grouped conv2/4/5, LRN after pool1
and pool2, a 4096-4096-1000 fullc head with dropout 0.5. The builder
returns config text, so both packages parse the same net from the same
string.
"""


def alexnet(nclass: int = 1000, batch_size: int = 256,
            image_size: int = 227, lr: float = 0.01) -> str:
    return """
netconfig=start
layer[0->1] = conv:conv1
  kernel_size = 11
  stride = 4
  nchannel = 96
layer[1->2] = relu:relu1
layer[2->3] = max_pooling:pool1
  kernel_size = 3
  stride = 2
layer[3->4] = lrn:lrn1
  local_size = 5
  alpha = 0.0001
  beta = 0.75
  knorm = 1
layer[4->5] = conv:conv2
  ngroup = 2
  nchannel = 256
  kernel_size = 5
  pad = 2
layer[5->6] = relu:relu2
layer[6->7] = max_pooling:pool2
  kernel_size = 3
  stride = 2
layer[7->8] = lrn:lrn2
  local_size = 5
  alpha = 0.0001
  beta = 0.75
  knorm = 1
layer[8->9] = conv:conv3
  nchannel = 384
  kernel_size = 3
  pad = 1
layer[9->10] = relu:relu3
layer[10->11] = conv:conv4
  nchannel = 384
  ngroup = 2
  kernel_size = 3
  pad = 1
layer[11->12] = relu:relu4
layer[12->13] = conv:conv5
  nchannel = 256
  ngroup = 2
  kernel_size = 3
  pad = 1
  init_bias = 1.0
layer[13->14] = relu:relu5
layer[14->15] = max_pooling:pool5
  kernel_size = 3
  stride = 2
layer[15->16] = flatten:flatten1
layer[16->17] = fullc:fc6
  nhidden = 4096
  init_sigma = 0.005
  init_bias = 1.0
layer[17->18] = relu:relu6
layer[18->18] = dropout:dropout1
  threshold = 0.5
layer[18->19] = fullc:fc7
  nhidden = 4096
  init_sigma = 0.005
  init_bias = 1.0
layer[19->20] = relu:relu7
layer[20->20] = dropout:dropout2
  threshold = 0.5
layer[20->21] = fullc:fc8
  nhidden = %d
layer[21->21] = softmax:softmax1
netconfig=end
metric = error
metric = rec@1
metric = rec@5
input_shape = 3,%d,%d
batch_size = %d
momentum = 0.9
wmat:lr = %g
wmat:wd = 0.0005
bias:wd = 0.000
bias:lr = %g
lr:schedule = expdecay
lr:gamma = 0.1
lr:step = 100000
random_type = xavier
""" % (nclass, image_size, image_size, batch_size, lr, lr * 2)
