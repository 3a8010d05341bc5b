function out = xmipp_matlab_bridge(func, args)
%XMIPP_MATLAB_BRIDGE core marshal helper for every xmipp_* / tom_xmipp_*
%wrapper in this directory.
%
%   out = xmipp_matlab_bridge(func, args)
%
% Saves the fields of struct ARGS to a temporary v7 MAT-file, invokes
% `xmipp_torch matlab_bridge --func FUNC -i in.mat -o out.mat` as an
% external process, and loads the result MAT-file into struct OUT.
%
% Design note (replaces the reference MEX adapters in bindings/matlab/):
% the compute path of the port owns a CUDA context, its kernels built at
% first use and the PyTorch runtime, which do not belong inside a MATLAB
% process, so the binding is a process boundary rather than an
% in-process MEX copy. MATLAB and Octave both speak v7 MAT natively; the
% Python side uses scipy.io. See xmipp3_tpu_torch/programs/matlab_bridge.py
% for the function registry and argument contracts.

fin = [tempname() '.mat'];
fout = [tempname() '.mat'];
save(fin, '-struct', 'args', '-v7');
cleanup = onCleanup(@() cellfun(@(f) delete_if(f), {fin, fout}));
cmd = sprintf('xmipp_torch matlab_bridge --func %s -i "%s" -o "%s"', ...
              func, fin, fout);
[status, msg] = system(cmd);
if status ~= 0
    error('xmipp_matlab_bridge:%s failed (%d): %s', func, status, msg);
end
out = load(fout);
end

function delete_if(f)
if exist(f, 'file')
    delete(f);
end
end
