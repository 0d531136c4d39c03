/*!
 * \file cxxnet_wrapper.h
 * \brief C ABI of the PyTorch port: the same entry points, shapes and
 *  buffer rules as wrapper/cxxnet_wrapper.h, so C, Matlab and FFI
 *  callers of the reference link against the port unchanged.
 *
 *  The library embeds a CPython interpreter (or, loaded into a live
 *  one, takes its GIL) and dispatches to cxxnet_tpu_torch.wrapper.
 *  Arrays cross the boundary as float32; 4-D batches are (batch,
 *  channel, height, width). Returned pointers reference a buffer owned
 *  by the handle, valid until the next call on that handle; callers
 *  must copy.
 *
 *  Devices: CXNNetCreate's device "cpu" runs on the CPU; any other name
 *  ("gpu", "tpu", "cuda") runs on the GPU and fails without one.
 *  CXXNET_TPU_PATH names the repo root when the library does not live
 *  in <root>/cxxnet_tpu_torch/_build.
 *
 *  Errors: failed calls print the Python error to stderr and return
 *  NULL/0; CXNGetLastError() returns the last message.
 */
#ifndef CXXNET_TPU_WRAPPER_H_
#define CXXNET_TPU_WRAPPER_H_

#ifdef __cplusplus
#define CXN_EXTERN extern "C"
#else
#define CXN_EXTERN
#endif
#define CXXNET_DLL CXN_EXTERN __attribute__((visibility("default")))

typedef float cxn_real_t;
typedef unsigned int cxn_uint;

/* ------------------------------------------------------------ iterator */
/*! \brief create a data iterator from config text ("iter = ... iter = end"
 *   block plus batch params); NULL on error */
CXXNET_DLL void *CXNIOCreateFromConfig(const char *cfg);
/*! \brief move to next batch; returns 0 at end of data */
CXXNET_DLL int CXNIONext(void *handle);
/*! \brief reset the iterator */
CXXNET_DLL void CXNIOBeforeFirst(void *handle);
/*! \brief current batch data as (batch, channel, height, width);
 *   oshape receives the 4 dims, ostride the last-dim stride (== width) */
CXXNET_DLL const cxn_real_t *CXNIOGetData(void *handle, cxn_uint oshape[4],
                                          cxn_uint *ostride);
/*! \brief current batch label as (batch, label_width) */
CXXNET_DLL const cxn_real_t *CXNIOGetLabel(void *handle, cxn_uint oshape[2],
                                           cxn_uint *ostride);
/*! \brief free the iterator */
CXXNET_DLL void CXNIOFree(void *handle);

/* ----------------------------------------------------------------- net */
/*! \brief create a net; device is "cpu" or a GPU name ("gpu", "tpu",
 *   "cuda"); cfg is config text; NULL on error */
CXXNET_DLL void *CXNNetCreate(const char *device, const char *cfg);
CXXNET_DLL void CXNNetFree(void *handle);
CXXNET_DLL void CXNNetSetParam(void *handle, const char *name,
                               const char *val);
CXXNET_DLL void CXNNetInitModel(void *handle);
CXXNET_DLL void CXNNetSaveModel(void *handle, const char *fname);
CXXNET_DLL void CXNNetLoadModel(void *handle, const char *fname);
CXXNET_DLL void CXNNetStartRound(void *handle, int round);
/*! \brief set weight of layer_name (tag "wmat"|"bias"); size_weight must
 *   match the layer's weight size; layout is the reference convention
 *   (fullc: out x in) */
CXXNET_DLL void CXNNetSetWeight(void *handle, const cxn_real_t *p_weight,
                                cxn_uint size_weight,
                                const char *layer_name, const char *tag);
/*! \brief get weight; oshape[0..*out_dim) receives the shape; returns
 *   NULL with *out_dim==0 when the layer/tag has no weight */
CXXNET_DLL const cxn_real_t *CXNNetGetWeight(void *handle,
                                             const char *layer_name,
                                             const char *tag,
                                             cxn_uint oshape[4],
                                             cxn_uint *out_dim);
/*! \brief one training step on the iterator's current batch */
CXXNET_DLL void CXNNetUpdateIter(void *handle, void *data_handle);
/*! \brief one training step on a raw batch; dshape is NCHW, lshape is
 *   (batch, label_width) */
CXXNET_DLL void CXNNetUpdateBatch(void *handle, const cxn_real_t *p_data,
                                  const cxn_uint dshape[4],
                                  const cxn_real_t *p_label,
                                  const cxn_uint lshape[2]);
/*! \brief predict class per row; *out_size receives the row count */
CXXNET_DLL const cxn_real_t *CXNNetPredictBatch(void *handle,
                                                const cxn_real_t *p_data,
                                                const cxn_uint dshape[4],
                                                cxn_uint *out_size);
CXXNET_DLL const cxn_real_t *CXNNetPredictIter(void *handle,
                                               void *data_handle,
                                               cxn_uint *out_size);
/*! \brief extract a named node's activations; oshape receives NCHW */
CXXNET_DLL const cxn_real_t *CXNNetExtractBatch(void *handle,
                                                const cxn_real_t *p_data,
                                                const cxn_uint dshape[4],
                                                const char *node_name,
                                                cxn_uint oshape[4]);
CXXNET_DLL const cxn_real_t *CXNNetExtractIter(void *handle,
                                               void *data_handle,
                                               const char *node_name,
                                               cxn_uint oshape[4]);
/*! \brief run a full eval pass; returns "\t<name>-<metric>:<value>";
 *   buffer owned by the handle */
CXXNET_DLL const char *CXNNetEvaluate(void *handle, void *data_handle,
                                      const char *name);

/*! \brief last error message ("" when none); thread-local */
CXXNET_DLL const char *CXNGetLastError(void);

#endif  /* CXXNET_TPU_WRAPPER_H_ */
